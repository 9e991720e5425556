"""Runtime-adaptive execution: monitor live memory/throughput, re-plan.

Rebuild of the reference's RuntimeAdaptiveExecutor
(/root/reference/parallelism/orchestrator.py:421-483): it registered
monitoring hooks on the model and switched parallelism strategy under memory
pressure. The shape here is different — sharding is a *compile-time*
property, so adaptation means choosing among pre-validated plans and
re-jitting — but the capability is the same:

  * :class:`RuntimeMonitor` samples device HBM occupancy
    (``device.memory_stats()``) and records per-step wall times.
  * :class:`AdaptiveExecutor` wraps an orchestrator; after each step it
    checks the monitor and, on sustained memory pressure (or an OOM-shaped
    failure), re-runs the cost-model search constrained to lower-memory
    plans and rebuilds the forward fn. Compiled fns are cached per plan so
    flapping between two plans doesn't recompile.

Pressure thresholds mirror the reference's (adapt when usage > 90% of the
budget; see orchestrator.py:450-470).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import jax

from mlio_tpu.models.spec import ModelSpec
from mlio_tpu.models.transformer import Impl
from mlio_tpu.parallel.auto_config import AutoParallelConfig
from mlio_tpu.parallel.orchestrator import ParallelOrchestrator, ParallelPlan


def device_memory_stats(device=None) -> Dict[str, float]:
    """Live HBM stats for one device; zeros when the backend exposes none
    (CPU test meshes). Parity: the reference's torch.cuda memory polling
    (utils/gpu_utils.py:9-68)."""
    device = device or jax.local_devices()[0]
    stats = {}
    try:
        stats = device.memory_stats() or {}
    except Exception:
        pass
    used = float(stats.get("bytes_in_use", 0))
    limit = float(stats.get("bytes_limit", 0))
    return {"bytes_in_use": used, "bytes_limit": limit,
            "fraction": used / limit if limit else 0.0}


class RuntimeMonitor:
    """Rolling window of memory fraction + step latency samples."""

    def __init__(self, window: int = 16,
                 stats_fn: Callable[[], Dict[str, float]] = None):
        self.window = window
        self._stats_fn = stats_fn or device_memory_stats
        self.mem_samples: List[float] = []
        self.step_times: List[float] = []
        self._t0: Optional[float] = None

    def step_start(self) -> None:
        self._t0 = time.perf_counter()

    def step_end(self) -> None:
        if self._t0 is not None:
            self.step_times = (self.step_times
                               + [time.perf_counter() - self._t0])[-self.window:]
            self._t0 = None
        self.mem_samples = (self.mem_samples
                            + [self._stats_fn()["fraction"]])[-self.window:]

    @property
    def memory_pressure(self) -> float:
        """Mean HBM fraction over the window (0 when unknown)."""
        return (sum(self.mem_samples) / len(self.mem_samples)
                if self.mem_samples else 0.0)

    @property
    def throughput_trend(self) -> float:
        """last-step / median step time (>1 = slowing down)."""
        if len(self.step_times) < 3:
            return 1.0
        mid = sorted(self.step_times)[len(self.step_times) // 2]
        return self.step_times[-1] / mid if mid else 1.0


class AdaptiveExecutor:
    """(parity: RuntimeAdaptiveExecutor orchestrator.py:421-483).

    ``executor.step(params, ids)`` runs the current plan's forward; the
    monitor records memory + latency, and when pressure stays above
    ``memory_threshold`` the executor searches for a plan whose estimated
    per-chip memory is lower and swaps it in (re-sharding params lazily).
    """

    def __init__(self, orch: ParallelOrchestrator, impl: Impl = Impl(),
                 *, memory_threshold: float = 0.9, patience: int = 3,
                 monitor: Optional[RuntimeMonitor] = None):
        self.orch = orch
        self.impl = impl
        self.memory_threshold = memory_threshold
        self.patience = patience
        self.monitor = monitor or RuntimeMonitor()
        self._over = 0
        self._fns: Dict[ParallelPlan, Callable] = {}
        self.adaptations: List[Dict] = []

    # -- execution -----------------------------------------------------------

    def _fn(self):
        plan = self.orch.plan
        if plan not in self._fns:
            self._fns[plan] = self.orch.forward_fn(self.impl)
        return self._fns[plan]

    def step(self, params, ids):
        self.monitor.step_start()
        try:
            out = self._fn()(params, ids)
        except Exception as e:  # OOM-shaped failures adapt immediately
            if "RESOURCE_EXHAUSTED" in str(e) or "out of memory" in str(e).lower():
                if self._adapt(ids.shape[0], ids.shape[1], reason="oom"):
                    params = self.orch.shard_params(params)
                    out = self._fn()(params, ids)
                else:
                    raise
            else:
                raise
        self.monitor.step_end()
        if self.monitor.memory_pressure > self.memory_threshold:
            self._over += 1
            if self._over >= self.patience:
                self._adapt(ids.shape[0], ids.shape[1], reason="pressure")
                self._over = 0
        else:
            self._over = 0
        return out

    # -- adaptation ----------------------------------------------------------

    def _adapt(self, batch: int, seq_len: int, *, reason: str) -> bool:
        """Search for a lower-memory plan; returns True if the plan changed.
        (parity: the reference's strategy switch orchestrator.py:450-483)."""
        current = self.orch.memory_usage_estimate(batch, seq_len)
        auto = AutoParallelConfig(self.orch.spec, hw=self.orch.hw)
        candidates = [c for c, _ in auto.search(batch, seq_len, top_k=16)]
        for cand in candidates:
            plan = ParallelPlan.from_candidate(cand)
            if plan == self.orch.plan:
                continue
            try:
                new = ParallelOrchestrator(plan, self.orch.spec,
                                           hw=self.orch.hw)
            except ValueError:
                continue
            est = new.memory_usage_estimate(batch, seq_len)
            if est["bytes_per_chip"] < current["bytes_per_chip"]:
                self.adaptations.append({
                    "reason": reason,
                    "from": dataclasses_asdict(self.orch.plan),
                    "to": dataclasses_asdict(plan),
                    "bytes_before": current["bytes_per_chip"],
                    "bytes_after": est["bytes_per_chip"],
                })
                self.orch = new
                return True
        return False


def dataclasses_asdict(plan: ParallelPlan) -> Dict:
    return {"tensor": plan.tensor, "sequence": plan.sequence,
            "pipeline": plan.pipeline, "data": plan.data}


__all__ = ["AdaptiveExecutor", "RuntimeMonitor", "device_memory_stats"]
