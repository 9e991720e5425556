"""Benchmark metric functions.

Rebuild of /root/reference/benchmarks/metrics.py:15-320 — throughput,
latency percentiles, memory efficiency, FLOPs utilization, speedup, memory
reduction, scaling efficiency, communication overhead, error metrics,
numerical stability, determinism — tokens/s per device and roofline
fraction against the device's published peaks (mlio_tpu.utils.peaks) are
first-class.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mlio_tpu.utils.peaks import device_peaks


def throughput_tokens_per_sec(num_tokens: int, elapsed_s: float,
                              num_chips: int = 1) -> Dict[str, float]:
    """(parity: metrics.py:15-40) + tokens/s/chip."""
    tps = num_tokens / elapsed_s if elapsed_s > 0 else 0.0
    return {"tokens_per_sec": tps, "tokens_per_sec_per_chip": tps / num_chips}


def latency_percentiles(times_s: Sequence[float]) -> Dict[str, float]:
    """p50..p99.99 (parity: metrics.py:42-80 + tail from
    scenarios/latency_tests.py:98)."""
    t = np.asarray(times_s) * 1e3
    if t.size == 0:
        return {}
    return {
        "mean_ms": float(t.mean()),
        "p50_ms": float(np.percentile(t, 50)),
        "p90_ms": float(np.percentile(t, 90)),
        "p95_ms": float(np.percentile(t, 95)),
        "p99_ms": float(np.percentile(t, 99)),
        "p99.99_ms": float(np.percentile(t, 99.99)),
        "min_ms": float(t.min()),
        "max_ms": float(t.max()),
    }


def memory_efficiency(model_bytes: int, total_bytes: int) -> float:
    """Fraction of memory that is model weights (parity: metrics.py:82-110)."""
    return model_bytes / total_bytes if total_bytes else 0.0


def flops_utilization(flops: float, elapsed_s: float,
                      kind: Optional[str] = None) -> float:
    """MFU against device ``kind``'s bf16 peak (parity: metrics.py:140-170)."""
    peak = device_peaks(kind).bf16_flops
    return flops / elapsed_s / peak if elapsed_s > 0 else 0.0


def bandwidth_utilization(bytes_accessed: float, elapsed_s: float,
                          kind: Optional[str] = None) -> float:
    """Achieved over device ``kind``'s published memory bandwidth."""
    peak = device_peaks(kind).hbm_bytes_per_s
    return bytes_accessed / elapsed_s / peak if elapsed_s else 0.0


def speedup(baseline_s: float, optimized_s: float) -> float:
    """(parity: metrics.py:112-126)."""
    return baseline_s / optimized_s if optimized_s > 0 else 0.0


def memory_reduction(baseline_bytes: int, optimized_bytes: int) -> float:
    """(parity: metrics.py:128-138)."""
    return 1.0 - optimized_bytes / baseline_bytes if baseline_bytes else 0.0


def scaling_efficiency(t_single: float, t_multi: float,
                       num_devices: int) -> float:
    """speedup / n (parity: metrics.py:172-191, runners.py:450-527)."""
    if t_multi <= 0 or num_devices <= 0:
        return 0.0
    return (t_single / t_multi) / num_devices


def communication_overhead(total_s: float, compute_s: float) -> float:
    """(parity: metrics.py:193-209)."""
    return max(0.0, total_s - compute_s) / total_s if total_s > 0 else 0.0


def relative_error(a, b) -> float:
    """(parity: metrics.py:211-239)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    denom = np.abs(b).max()
    return float(np.abs(a - b).max() / denom) if denom else 0.0


def max_abs_error(a, b) -> float:
    """(parity: metrics.py:241-263)."""
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def check_numerical_stability(x) -> Dict[str, bool]:
    """NaN/Inf check (parity: metrics.py:265-280)."""
    arr = np.asarray(x, np.float32)
    return {"has_nan": bool(np.isnan(arr).any()),
            "has_inf": bool(np.isinf(arr).any()),
            "stable": bool(np.isfinite(arr).all())}


def verify_determinism(fn, *args, runs: int = 5,
                       rtol: float = 1e-5, atol: float = 1e-5) -> bool:
    """N-run determinism (parity: metrics.py:282-320)."""
    ref = np.asarray(fn(*args))
    for _ in range(runs - 1):
        out = np.asarray(fn(*args))
        if not np.allclose(out, ref, rtol=rtol, atol=atol):
            return False
    return True


def perplexity(logits, targets) -> float:
    """Token-level perplexity — backs the INT8 "≤0.1 ppl delta" gate
    (BASELINE.md). logits [B, S, V], targets [B, S]."""
    logits = jnp.asarray(logits, jnp.float32)
    logp = jax.nn.log_softmax(logits, axis=-1)
    tgt = jnp.take_along_axis(logp, jnp.asarray(targets)[..., None],
                              axis=-1)[..., 0]
    return float(jnp.exp(-jnp.mean(tgt)))


def perplexity_delta(params_a, params_b, spec, token_ids,
                     forward_fn=None) -> Dict[str, float]:
    """Perplexity of two parameter sets (e.g. fp16 vs int8) on the same
    token stream; the quantization accuracy gate."""
    from mlio_tpu.models.transformer import forward as _fwd

    fwd = forward_fn or _fwd
    inputs = token_ids[:, :-1]
    targets = token_ids[:, 1:]
    la, _ = fwd(params_a, spec, inputs)
    lb, _ = fwd(params_b, spec, inputs)
    pa = perplexity(la, targets)
    pb = perplexity(lb, targets)
    return {"ppl_a": pa, "ppl_b": pb, "delta": pb - pa}
