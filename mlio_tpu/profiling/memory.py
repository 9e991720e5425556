"""Device memory tracking: time series, per-layer usage, leak detection,
max-batch search.

Rebuild of /root/reference/profiling/memory_tracker.py (GPUMemoryTracker
:16-135, per-layer hooks :138, leak detector :208, binary-search max batch
:264) against jax device memory_stats instead of torch.cuda counters.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mlio_tpu.profiling.profiler import device_memory_stats


class DeviceMemoryTracker:
    """Start/stop tracker with a sampled time series
    (parity: GPUMemoryTracker memory_tracker.py:16-135)."""

    def __init__(self, device: Optional[jax.Device] = None):
        self.device = device or jax.devices()[0]
        self.samples: List[Dict[str, Any]] = []
        self._active = False

    def start(self) -> None:
        self.samples = []
        self._active = True
        self.sample("start")

    def sample(self, label: str = "") -> Dict[str, Any]:
        s = {"t": time.time(), "label": label,
             **device_memory_stats(self.device)}
        if self._active:
            self.samples.append(s)
        return s

    def stop(self) -> Dict[str, Any]:
        self.sample("stop")
        self._active = False
        in_use = [s["bytes_in_use"] for s in self.samples]
        return {
            "peak_bytes": max((s["peak_bytes_in_use"] for s in self.samples),
                              default=0),
            "min_bytes": min(in_use, default=0),
            "max_bytes": max(in_use, default=0),
            "num_samples": len(self.samples),
        }


def per_layer_memory(spec, batch_size: int = 1, seq_len: int = 128,
                     dtype=jnp.bfloat16) -> Dict[str, int]:
    """Analytic per-layer memory (weights + activations) — the
    replacement for forward-hook measurement (memory_tracker.py:138-205):
    under jit there are no per-layer hooks, so this reports the static
    model's per-layer footprint."""
    h, i = spec.hidden_size, spec.intermediate_size
    bytes_per = jnp.dtype(dtype).itemsize
    attn_w = (spec.q_dim * h * 2 + spec.kv_dim * h * 2)
    mlp_w = h * i * (3 if spec.activation == "swiglu" else 2)
    act = batch_size * seq_len * (h * 4 + i)
    return {
        "attention_weights_bytes": attn_w * bytes_per,
        "mlp_weights_bytes": mlp_w * bytes_per,
        "activation_bytes": act * bytes_per,
        "kv_per_token_bytes": 2 * spec.kv_dim * bytes_per,
        "total_layer_bytes": (attn_w + mlp_w + act) * bytes_per,
    }


def detect_memory_leak(fn: Callable, *args, iterations: int = 5,
                       tolerance_bytes: int = 1 << 20) -> Dict[str, Any]:
    """Run fn repeatedly; flag monotone growth in live bytes
    (parity: memory_tracker.py:208-261)."""
    readings = []
    for _ in range(iterations):
        out = fn(*args)
        jax.tree_util.tree_map(
            lambda x: x.block_until_ready() if hasattr(x, "block_until_ready") else x,
            out)
        del out
        readings.append(device_memory_stats()["bytes_in_use"])
    growth = np.diff(readings)
    leaking = bool(len(growth) > 1 and (growth[1:] > tolerance_bytes).all())
    return {"readings": readings, "leaking": leaking,
            "total_growth_bytes": int(readings[-1] - readings[0])}


def find_max_batch_size(
    make_fn: Callable[[int], Callable[[], Any]],
    low: int = 1,
    high: int = 1024,
) -> int:
    """Binary-search the largest batch size that executes without OOM
    (parity: memory_tracker.py:264-343). ``make_fn(b)`` returns a thunk
    running the workload at batch b."""
    def fits(b: int) -> bool:
        try:
            out = make_fn(b)()
            jax.tree_util.tree_map(
                lambda x: x.block_until_ready() if hasattr(x, "block_until_ready") else x,
                out)
            return True
        except Exception:
            return False

    if not fits(low):
        return 0
    while low < high:
        mid = (low + high + 1) // 2
        if fits(mid):
            low = mid
        else:
            high = mid - 1
    return low
