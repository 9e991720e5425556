"""Benchmark runners: sweep batch × seq × implementation variants.

Rebuild of /root/reference/benchmarks/runners.py (BenchmarkConfig :28,
BenchmarkRunner :53-330, Throughput :333 / Latency :363 / Memory :408 /
Scaling :450 subclasses): warmup, timed loops with hard syncs, per-variant
output validation against the baseline variant (allclose rtol/atol 1e-3,
runners.py:250-297), JSON persistence. Here every timed region is
a jitted callable, the sync is a device fetch, and scaling runs over a real
device mesh instead of multi-process NCCL.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mlio_tpu.benchmarks import metrics as M
from mlio_tpu.models.spec import ModelSpec
from mlio_tpu.models.transformer import Impl, forward


@dataclasses.dataclass
class BenchmarkConfig:
    """(parity: BenchmarkConfig runners.py:28-50)."""

    batch_sizes: Sequence[int] = (1, 8)
    seq_lens: Sequence[int] = (128, 512)
    warmup_iters: int = 2
    iters: int = 5
    validate_outputs: bool = True
    rtol: float = 1e-3
    atol: float = 1e-3
    output_dir: str = "benchmark_results"
    dtype: Any = jnp.float32


DEFAULT_VARIANTS: Dict[str, Impl] = {
    # (parity: the 7-config A/B harness, baseline/inference.py:1682-1776)
    "baseline": Impl(),
    "flash_attention": Impl(attention="flash"),
}


class BenchmarkRunner:
    """(parity: BenchmarkRunner runners.py:53-330)."""

    name = "benchmark"

    def __init__(self, config: Optional[BenchmarkConfig] = None,
                 variants: Optional[Dict[str, Impl]] = None):
        self.config = config or BenchmarkConfig()
        self.variants = variants or dict(DEFAULT_VARIANTS)
        self.results: List[Dict[str, Any]] = []

    # -- harness -------------------------------------------------------------

    def _timed(self, fn: Callable, *args) -> Dict[str, Any]:
        out = fn(*args)
        jax.tree_util.tree_map(lambda x: np.asarray(x), out)  # hard sync
        for _ in range(self.config.warmup_iters - 1):
            fn(*args)
        times = []
        for _ in range(self.config.iters):
            t0 = time.perf_counter()
            out = fn(*args)
            _ = np.asarray(jax.tree_util.tree_leaves(out)[0])
            times.append(time.perf_counter() - t0)
        return {"times_s": times, "output": out}

    def run_model_sweep(self, spec: ModelSpec, params) -> List[Dict[str, Any]]:
        """Sweep batch×seq×variant on a model forward; validate outputs vs
        the 'baseline' variant (runners.py:250-297)."""
        cfg = self.config
        for batch in cfg.batch_sizes:
            for seq in cfg.seq_lens:
                ids = jax.random.randint(jax.random.PRNGKey(0), (batch, seq),
                                         0, spec.vocab_size)
                baseline_out = None
                for vname, impl in self.variants.items():
                    fn = jax.jit(lambda p, i, impl=impl:
                                 forward(p, spec, i, impl=impl)[0])
                    r = self._timed(fn, params, ids)
                    entry = {
                        "runner": self.name,
                        "variant": vname,
                        "batch": batch,
                        "seq_len": seq,
                        **M.latency_percentiles(r["times_s"]),
                        **M.throughput_tokens_per_sec(
                            batch * seq, float(np.mean(r["times_s"]))),
                        **M.check_numerical_stability(r["output"]),
                    }
                    if vname == "baseline":
                        baseline_out = r["output"]
                        entry["validated"] = True
                    elif cfg.validate_outputs and baseline_out is not None:
                        entry["max_abs_error"] = M.max_abs_error(
                            r["output"], baseline_out)
                        entry["validated"] = bool(np.allclose(
                            np.asarray(r["output"], np.float32),
                            np.asarray(baseline_out, np.float32),
                            rtol=cfg.rtol, atol=cfg.atol))
                        if baseline_out is not None:
                            base_mean = [e for e in self.results
                                         if e["variant"] == "baseline"
                                         and e["batch"] == batch
                                         and e["seq_len"] == seq]
                            if base_mean:
                                entry["speedup"] = M.speedup(
                                    base_mean[0]["mean_ms"], entry["mean_ms"])
                    self.results.append(entry)
        return self.results

    def save_results(self, path: Optional[str] = None) -> str:
        """(parity: runners.py:299-330)."""
        out_dir = Path(self.config.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        path = Path(path) if path else out_dir / f"{self.name}_results.json"
        path.write_text(json.dumps(
            {"name": self.name, "results": self.results}, indent=2,
            default=float))
        return str(path)


class ThroughputBenchmark(BenchmarkRunner):
    """tokens/sec decode throughput (parity: runners.py:333-360)."""

    name = "throughput"

    def run_decode(self, spec: ModelSpec, params, *, batch: int = 8,
                   prompt_len: int = 8, new_tokens: int = 64,
                   impl: Impl = Impl(), cache_len: Optional[int] = None
                   ) -> Dict[str, Any]:
        from mlio_tpu.runtime.generate import generate

        ids = jnp.zeros((batch, prompt_len), jnp.int32)
        cache_len = cache_len or min(spec.max_seq_len,
                                     prompt_len + new_tokens)

        def run():
            out = generate(params, spec, ids, max_new_tokens=new_tokens,
                           impl=impl, cache_len=cache_len)
            return int(out[0, -1])

        run()
        times = []
        for _ in range(max(1, self.config.iters // 2)):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        mean = float(np.mean(times))
        entry = {
            "runner": self.name, "batch": batch, "new_tokens": new_tokens,
            **M.throughput_tokens_per_sec(batch * new_tokens, mean),
            **M.latency_percentiles(times),
        }
        self.results.append(entry)
        return entry


class LatencyBenchmark(BenchmarkRunner):
    """Single-sample + percentile latency (parity: runners.py:363-405)."""

    name = "latency"

    def run_single(self, spec: ModelSpec, params, *, seq_len: int = 128,
                   impl: Impl = Impl(), iters: Optional[int] = None
                   ) -> Dict[str, Any]:
        ids = jax.random.randint(jax.random.PRNGKey(0), (1, seq_len), 0,
                                 spec.vocab_size)
        fn = jax.jit(lambda p, i: forward(p, spec, i, impl=impl)[0])
        r = self._timed(fn, params, ids)
        times = r["times_s"]
        for _ in range((iters or self.config.iters) - len(times)):
            t0 = time.perf_counter()
            _ = np.asarray(fn(params, ids))
            times.append(time.perf_counter() - t0)
        entry = {"runner": self.name, "seq_len": seq_len,
                 **M.latency_percentiles(times)}
        self.results.append(entry)
        return entry


class MemoryBenchmark(BenchmarkRunner):
    """Parameter/cache memory accounting (parity: runners.py:408-447)."""

    name = "memory"

    def run_memory(self, spec: ModelSpec, params, *, batch: int = 1,
                   seq_len: int = 512, cache_dtype=jnp.bfloat16
                   ) -> Dict[str, Any]:
        from mlio_tpu.runtime.kv_cache import cache_memory_bytes
        from mlio_tpu.runtime.quantization import quantized_size_bytes

        param_bytes = quantized_size_bytes(params)
        kv_bytes = cache_memory_bytes(spec, batch, seq_len, cache_dtype)
        entry = {
            "runner": self.name,
            "param_bytes": param_bytes,
            "kv_cache_bytes": kv_bytes,
            "total_bytes": param_bytes + kv_bytes,
            "memory_efficiency": M.memory_efficiency(
                param_bytes, param_bytes + kv_bytes),
        }
        self.results.append(entry)
        return entry


class ScalingBenchmark(BenchmarkRunner):
    """1-device vs N-device scaling efficiency over a real mesh
    (parity: runners.py:450-527, rebuilt on jax.sharding instead of
    multi-process NCCL)."""

    name = "scaling"

    def run_scaling(self, spec: ModelSpec, params, *, batch: int = 8,
                    seq_len: int = 128, num_devices: Optional[int] = None
                    ) -> Dict[str, Any]:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from mlio_tpu.parallel import make_mesh

        n = num_devices or jax.device_count()
        ids = jax.random.randint(jax.random.PRNGKey(0), (batch, seq_len), 0,
                                 spec.vocab_size)
        fn = jax.jit(lambda p, i: forward(p, spec, i)[0])
        t1 = self._timed(fn, params, ids)["times_s"]

        mesh = make_mesh(data=n)
        ids_sharded = jax.device_put(ids, NamedSharding(mesh, P("data", None)))
        params_rep = jax.device_put(
            params, NamedSharding(mesh, P()))
        tn = self._timed(fn, params_rep, ids_sharded)["times_s"]

        eff = M.scaling_efficiency(float(np.mean(t1)), float(np.mean(tn)), n)
        entry = {
            "runner": self.name, "num_devices": n, "batch": batch,
            "seq_len": seq_len,
            "single_mean_ms": float(np.mean(t1)) * 1e3,
            "multi_mean_ms": float(np.mean(tn)) * 1e3,
            "scaling_efficiency": eff,
        }
        self.results.append(entry)
        return entry
