"""Profiler wrapper: wall-time stats + XLA traces + compiled-cost tables.

Rebuild of /root/reference/profiling/torch_profiler.py (ProfilerConfig :18,
ProfileResults :55, TorchProfilerWrapper :190) on the JAX stack: the
torch.profiler activity tables become (a) ``jax.profiler.trace`` captures
(TensorBoard/Perfetto-compatible) and (b) XLA compiled-artifact cost and
memory analyses, which give FLOPs/bytes per executable without tracing
overhead.
"""
from __future__ import annotations

import dataclasses
import json
import pickle
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import jax
import numpy as np


@dataclasses.dataclass
class ProfilerConfig:
    """(parity: ProfilerConfig torch_profiler.py:18-52)."""

    trace_dir: Optional[str] = None     # capture an XLA trace when set
    warmup_steps: int = 2
    active_steps: int = 5
    capture_memory: bool = True
    capture_cost: bool = True           # XLA cost analysis of the jitted fn


@dataclasses.dataclass
class ProfileResults:
    """Timing + cost + memory results (parity: ProfileResults
    torch_profiler.py:55-187)."""

    wall_times_s: List[float]
    cost: Dict[str, float]              # flops, bytes accessed, ...
    memory: Dict[str, Any]              # device memory stats
    trace_dir: Optional[str] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def mean_s(self) -> float:
        return float(np.mean(self.wall_times_s)) if self.wall_times_s else 0.0

    def percentile(self, p: float) -> float:
        return float(np.percentile(self.wall_times_s, p))

    def summary(self) -> Dict[str, Any]:
        t = np.asarray(self.wall_times_s)
        flops = self.cost.get("flops", 0.0)
        out = {
            "mean_ms": float(t.mean() * 1e3) if t.size else 0.0,
            "p50_ms": float(np.percentile(t, 50) * 1e3) if t.size else 0.0,
            "p99_ms": float(np.percentile(t, 99) * 1e3) if t.size else 0.0,
            "flops": flops,
            "bytes_accessed": self.cost.get("bytes accessed", 0.0),
            "tflops_per_s": (flops / t.mean() / 1e12) if (t.size and flops) else 0.0,
            **{f"mem_{k}": v for k, v in self.memory.items()},
        }
        return out

    def to_dataframe(self):
        """Cost table as pandas DataFrame (parity: key_averages→pandas,
        torch_profiler.py:92-130)."""
        import pandas as pd

        rows = [{"metric": k, "value": v} for k, v in
                {**self.summary()}.items()]
        return pd.DataFrame(rows)

    def top_costs(self, k: int = 10) -> List[tuple]:
        """Top-k cost entries (parity: top-k ops torch_profiler.py:131)."""
        items = sorted(self.cost.items(), key=lambda kv: -abs(kv[1]))
        return items[:k]

    def save(self, path) -> None:
        """(parity: pickle save torch_profiler.py:165-187)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        if path.suffix == ".json":
            payload = dataclasses.asdict(self)
            path.write_text(json.dumps(payload, default=float, indent=2))
        else:
            path.write_bytes(pickle.dumps(self))

    @staticmethod
    def load(path) -> "ProfileResults":
        path = Path(path)
        if path.suffix == ".json":
            d = json.loads(path.read_text())
            return ProfileResults(**d)
        return pickle.loads(path.read_bytes())


def device_memory_stats(device: Optional[jax.Device] = None) -> Dict[str, Any]:
    """Device memory snapshot (parity: utils/gpu_utils.py:9-68)."""
    if device is None:
        device = jax.devices()[0]
    try:
        stats = device.memory_stats() or {}
    except Exception:
        stats = {}
    return {
        "bytes_in_use": stats.get("bytes_in_use", 0),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use", 0),
        "bytes_limit": stats.get("bytes_limit", 0),
    }


class ProfilerWrapper:
    """Profile jitted callables (parity: TorchProfilerWrapper
    torch_profiler.py:190-296)."""

    def __init__(self, config: Optional[ProfilerConfig] = None):
        self.config = config or ProfilerConfig()
        self.results: List[ProfileResults] = []

    def profile_function(self, fn: Callable, *args,
                         name: str = "fn") -> ProfileResults:
        cfg = self.config
        jitted = jax.jit(fn) if not hasattr(fn, "lower") else fn

        cost: Dict[str, float] = {}
        if cfg.capture_cost:
            try:
                lowered = jitted.lower(*args)
                compiled = lowered.compile()
                analysis = compiled.cost_analysis()
                if isinstance(analysis, (list, tuple)):
                    analysis = analysis[0] if analysis else {}
                cost = {k: float(v) for k, v in (analysis or {}).items()
                        if isinstance(v, (int, float))}
            except Exception:
                cost = {}

        def run_once():
            out = jitted(*args)
            jax.tree_util.tree_map(
                lambda x: x.block_until_ready() if hasattr(x, "block_until_ready") else x,
                out)
            return out

        for _ in range(cfg.warmup_steps):
            run_once()

        mem_before = device_memory_stats() if cfg.capture_memory else {}

        times = []
        trace_ctx = (jax.profiler.trace(cfg.trace_dir)
                     if cfg.trace_dir else _nullcontext())
        with trace_ctx:
            for _ in range(cfg.active_steps):
                t0 = time.perf_counter()
                run_once()
                times.append(time.perf_counter() - t0)

        mem_after = device_memory_stats() if cfg.capture_memory else {}
        memory = {"before": mem_before, "after": mem_after,
                  "delta_bytes": (mem_after.get("bytes_in_use", 0)
                                  - mem_before.get("bytes_in_use", 0))} \
            if cfg.capture_memory else {}

        res = ProfileResults(wall_times_s=times, cost=cost, memory=memory,
                             trace_dir=cfg.trace_dir, meta={"name": name})
        self.results.append(res)
        return res

    def profile_model(self, params, spec, ids, *, impl=None,
                      name: str = "model") -> ProfileResults:
        """(parity: profile_model torch_profiler.py:200-250 and
        InferenceRunner.profile_model inference.py:748)."""
        from mlio_tpu.models.transformer import Impl, forward

        impl = impl or Impl()

        def fn(params, ids):
            logits, _ = forward(params, spec, ids, impl=impl)
            return logits

        return self.profile_function(fn, params, ids, name=name)


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False
