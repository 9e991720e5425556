"""Rule-based optimization recommendation engine.

Rebuild of /root/reference/dashboard/recommendation.py
(generate_optimization_recommendations :14-79, OptimizationRecommender
:80-266, ParallelismRecommender :267, KernelOptimizationRecommender :382,
MemoryOptimizationRecommender :534, OperationFusionRecommender :667) —
the bottleneck classes come from the roofline analyzer
(profiling/bottleneck.py) and the suggested actions map to this framework's
levers (Impl kernels, QTensor quantization, mesh plans, paged cache).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from mlio_tpu.profiling.bottleneck import BottleneckReport, BottleneckType


@dataclasses.dataclass
class Recommendation:
    title: str
    category: str          # kernel | parallelism | memory | fusion | runtime
    estimated_gain: str    # human-readable improvement estimate
    priority: int          # 1 (highest) .. 5
    action: str            # the concrete framework lever


def generate_optimization_recommendations(
    report: BottleneckReport,
    config: Optional[Dict[str, Any]] = None,
) -> List[Recommendation]:
    """(parity: recommendation.py:14-79): bottleneck list + config →
    prioritized recommendations."""
    recs: List[Recommendation] = []
    for rec_class in (KernelOptimizationRecommender, ParallelismRecommender,
                      MemoryOptimizationRecommender,
                      OperationFusionRecommender):
        recs.extend(rec_class().recommend(report, config or {}))
    recs.sort(key=lambda r: r.priority)
    return recs


class OptimizationRecommender:
    """(parity: OptimizationRecommender recommendation.py:80-266)."""

    category = "general"

    def recommend(self, report: BottleneckReport,
                  config: Dict[str, Any]) -> List[Recommendation]:
        return []

    # shared helpers -----------------------------------------------------

    @staticmethod
    def _has(report: BottleneckReport, kind: BottleneckType) -> float:
        for b in report.bottlenecks:
            if b.kind == kind:
                return b.severity
        return 0.0


class KernelOptimizationRecommender(OptimizationRecommender):
    """(parity: recommendation.py:382-533)."""

    category = "kernel"

    def recommend(self, report, config):
        recs = []
        util = report.metrics.get("flops_utilization", 0.0)
        if self._has(report, BottleneckType.COMPUTE) and util < 0.5:
            recs.append(Recommendation(
                "Enable the GPU kernels",
                self.category,
                f"MFU {util:.0%}: cuDNN fused attention for prefill and the "
                "paged decode kernel", 1, 'Impl(attention="flash")'))
        if config.get("attention") == "dense":
            recs.append(Recommendation(
                "Switch dense attention to cuDNN flash attention",
                self.category, "O(S^2) score memory removed; several times "
                "faster prefill attention at 1K+ ctx", 1,
                'Impl(attention="flash")'))
        if config.get("seq_len", 0) >= 16384:
            recs.append(Recommendation(
                "Use ring attention for long context", self.category,
                "KV memory drops to S/devices per chip", 2,
                "sequence_parallel_attention(..., strategy='ring')"))
        return recs


class ParallelismRecommender(OptimizationRecommender):
    """(parity: recommendation.py:267-381)."""

    category = "parallelism"

    def recommend(self, report, config):
        recs = []
        comm = self._has(report, BottleneckType.COMMUNICATION)
        if comm > 0.3:
            recs.append(Recommendation(
                "Reduce communication volume", self.category,
                f"comm is {comm:.0%} of step time", 1,
                "lower comm dtype to bf16; keep TP inside one host's "
                "NVLink domain; "
                "re-run AutoParallelConfig.search()"))
        n_dev = config.get("num_devices", 1)
        if n_dev == 1 and config.get("model_params", 0) > 3e9:
            recs.append(Recommendation(
                "Shard the model", self.category,
                "multi-billion-param model on one chip is memory-starved",
                1, "ParallelOrchestrator.auto(spec) → TP plan"))
        if config.get("tensor_parallel_size", 1) > 8:
            recs.append(Recommendation(
                "TP group spans hosts", self.category,
                "TP collectives leave NVLink for the network", 1,
                "cap tensor_parallel_size at chips-per-host; use DP/PP "
                "across hosts"))
        return recs


class MemoryOptimizationRecommender(OptimizationRecommender):
    """(parity: recommendation.py:534-666)."""

    category = "memory"

    def recommend(self, report, config):
        recs = []
        if self._has(report, BottleneckType.MEMORY) > 0.4:
            recs.append(Recommendation(
                "Quantize weights to INT8", self.category,
                "halves HBM weight traffic; ~1.2-1.8x decode", 1,
                'quantize_params(params, spec, "int8")'))
            recs.append(Recommendation(
                "Quantize the KV cache to INT8", self.category,
                "halves KV traffic at long context", 2,
                'init_cache(..., quant="int8")'))
        if config.get("hbm_fraction", 0.0) > 0.85:
            recs.append(Recommendation(
                "Switch to the paged KV cache", self.category,
                "block-granular allocation removes per-sequence "
                "over-reservation", 2,
                "InferenceEngine(...)  # paged pools + continuous batching"))
        return recs


class OperationFusionRecommender(OptimizationRecommender):
    """(parity: recommendation.py:667-828)."""

    category = "fusion"

    def recommend(self, report, config):
        recs = []
        if self._has(report, BottleneckType.MEMORY) > 0.2 \
                and not config.get("fused_projections", False):
            recs.append(Recommendation(
                "Fuse the Q/K/V and up/gate projections", self.category,
                "one matmul (and one read of the activation) instead of "
                "three per layer", 3,
                "runtime.quantization.fuse_projections(params, spec)"))
        if self._has(report, BottleneckType.OVERHEAD) > 0.3:
            recs.append(Recommendation(
                "Amortize dispatch overhead", self.category,
                f"{report.metrics.get('wall_time_ms', 0):.1f} ms/step with "
                "large unexplained fraction", 1,
                "move the decode loop inside jit (lax.scan) / use "
                "InferenceEngine batched steps"))
        return recs


def recommendations_to_json(recs: List[Recommendation]) -> List[Dict]:
    return [dataclasses.asdict(r) for r in recs]
