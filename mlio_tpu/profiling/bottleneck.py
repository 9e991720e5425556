"""Bottleneck analysis from XLA cost analysis + roofline classification.

Rebuild of /root/reference/profiling/bottleneck_analyzer.py (BottleneckType
:20, BottleneckReport :31-150, BottleneckAnalyzer :153-521). The reference
classifies by kernel-name pattern matching over profiler tables; this
version classifies from first principles: XLA's compiled cost analysis gives
FLOPs and bytes accessed, and the device's roofline (peak FLOP/s vs memory
bytes/s from mlio_tpu.utils.peaks) decides compute- vs memory-bound; measured wall time vs cost-model time
exposes overhead/communication-bound executables.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Dict, List, Optional

import numpy as np

from mlio_tpu.utils.peaks import device_peaks


class BottleneckType(enum.Enum):
    """(parity: bottleneck_analyzer.py:20-28)."""

    COMPUTE = "compute"
    MEMORY = "memory"
    COMMUNICATION = "communication"
    IO = "io"
    OVERHEAD = "overhead"
    MIXED = "mixed"




@dataclasses.dataclass
class Bottleneck:
    kind: BottleneckType
    severity: float          # 0..1 fraction of step time attributed
    detail: str
    suggestions: List[str]


@dataclasses.dataclass
class BottleneckReport:
    """(parity: BottleneckReport bottleneck_analyzer.py:31-150)."""

    bottlenecks: List[Bottleneck]
    metrics: Dict[str, float]

    @property
    def primary(self) -> Optional[Bottleneck]:
        return max(self.bottlenecks, key=lambda b: b.severity, default=None)

    def to_text(self) -> str:
        lines = ["Bottleneck report", "=" * 40]
        for k, v in self.metrics.items():
            lines.append(f"  {k}: {v:.4g}")
        for b in sorted(self.bottlenecks, key=lambda b: -b.severity):
            lines.append(f"\n[{b.kind.value}] severity {b.severity:.2f}")
            lines.append(f"  {b.detail}")
            for s in b.suggestions:
                lines.append(f"  -> {s}")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "metrics": self.metrics,
            "bottlenecks": [
                {"kind": b.kind.value, "severity": b.severity,
                 "detail": b.detail, "suggestions": b.suggestions}
                for b in self.bottlenecks],
        }, indent=2)


_SUGGESTIONS = {
    # (parity: per-class suggestions bottleneck_analyzer.py:442-521)
    BottleneckType.COMPUTE: [
        "use bf16 (or fp8/int8) to raise tensor-core throughput",
        "increase batch size to improve tensor-core utilization",
        "use Impl(attention=\"flash\") for cuDNN fused attention",
        "shard with tensor parallelism to add cards",
    ],
    BottleneckType.MEMORY: [
        "quantize weights to int8/int4 (dequant-fused matmul halves HBM reads)",
        "quantize the KV cache to int8",
        "use flash/paged attention to avoid materializing score matrices",
        "increase batch size so weight reads amortize over more tokens",
    ],
    BottleneckType.COMMUNICATION: [
        "keep tensor-parallel groups within one host's NVLink domain",
        "use ring attention (ppermute) instead of all-gather for long context",
        "overlap collectives with compute (XLA latency-hiding is on by default)",
        "lower communication dtype to bf16",
    ],
    BottleneckType.OVERHEAD: [
        "move the loop inside jit (lax.scan) to amortize dispatch",
        "batch multiple requests per step (continuous batching)",
        "avoid host<->device transfers in the hot loop",
    ],
}


class BottleneckAnalyzer:
    """(parity: BottleneckAnalyzer bottleneck_analyzer.py:153-440)."""

    def __init__(self, kind: Optional[str] = None):
        """``kind``: device kind whose published peaks bound the roofline
        (default: the first JAX device's)."""
        peaks = device_peaks(kind)
        self.peak_flops = peaks.bf16_flops
        self.hbm_bps = peaks.hbm_bytes_per_s
        self.link_bps = peaks.link_bytes_per_s

    def analyze(self, *, wall_time_s: float, flops: float = 0.0,
                bytes_accessed: float = 0.0, comm_bytes: float = 0.0,
                num_devices: int = 1) -> BottleneckReport:
        """Classify a measured step against the roofline."""
        t_compute = flops / self.peak_flops / max(1, num_devices)
        t_memory = bytes_accessed / self.hbm_bps / max(1, num_devices)
        t_comm = comm_bytes / self.link_bps if comm_bytes else 0.0
        t_model = max(t_compute, t_memory) + t_comm
        overhead = max(0.0, wall_time_s - t_model)

        intensity = flops / bytes_accessed if bytes_accessed else float("inf")
        ridge = self.peak_flops / self.hbm_bps

        bottlenecks = []
        denom = max(wall_time_s, 1e-12)
        if t_compute >= t_memory and flops:
            bottlenecks.append(Bottleneck(
                BottleneckType.COMPUTE, min(1.0, t_compute / denom),
                f"arithmetic intensity {intensity:.1f} FLOP/B >= ridge "
                f"{ridge:.1f}; tensor-core-bound at {flops / denom / 1e12:.1f} TFLOP/s "
                f"({flops / denom / self.peak_flops:.0%} of peak)",
                _SUGGESTIONS[BottleneckType.COMPUTE]))
        if t_memory > t_compute and bytes_accessed:
            bottlenecks.append(Bottleneck(
                BottleneckType.MEMORY, min(1.0, t_memory / denom),
                f"arithmetic intensity {intensity:.1f} FLOP/B < ridge "
                f"{ridge:.1f}; HBM-bound at "
                f"{bytes_accessed / denom / 1e9:.0f} GB/s "
                f"({bytes_accessed / denom / self.hbm_bps:.0%} of peak)",
                _SUGGESTIONS[BottleneckType.MEMORY]))
        if t_comm:
            bottlenecks.append(Bottleneck(
                BottleneckType.COMMUNICATION, min(1.0, t_comm / denom),
                f"{comm_bytes / 1e6:.1f} MB over the card links per step",
                _SUGGESTIONS[BottleneckType.COMMUNICATION]))
        if overhead / denom > 0.3:
            bottlenecks.append(Bottleneck(
                BottleneckType.OVERHEAD, min(1.0, overhead / denom),
                f"{overhead * 1e3:.2f} ms ({overhead / denom:.0%}) not "
                "explained by compute/memory/comm — dispatch or host-sync "
                "overhead",
                _SUGGESTIONS[BottleneckType.OVERHEAD]))

        metrics = {
            "wall_time_ms": wall_time_s * 1e3,
            "model_time_ms": t_model * 1e3,
            "compute_time_ms": t_compute * 1e3,
            "memory_time_ms": t_memory * 1e3,
            "comm_time_ms": t_comm * 1e3,
            "arithmetic_intensity": 0.0 if intensity == float("inf") else intensity,
            "flops_utilization": flops / denom / self.peak_flops if flops else 0.0,
            "bandwidth_utilization": (bytes_accessed / denom / self.hbm_bps
                                      if bytes_accessed else 0.0),
        }
        return BottleneckReport(bottlenecks=bottlenecks, metrics=metrics)

    def analyze_op_table(self, results, top_k: int = 5) -> BottleneckReport:
        """Name the ops that dominate measured device time.

        ``results`` is a KernelProfileResults (or an xplane OpTable). This
        is the per-op half the reference's analyzer gets from kernel-name
        tables (bottleneck_analyzer.py:225-297) — here each named op comes
        with its measured share of device time, and low op-time coverage of
        the wall clock is flagged as dispatch/host overhead.
        """
        table = getattr(results, "table", results)
        wall_s = getattr(results, "wall_time_s", 0.0)
        top = table.top(top_k)
        bottlenecks = [
            Bottleneck(
                BottleneckType.MIXED, op.pct / 100.0,
                f"op '{op.name}' {op.total_us:.0f}us total "
                f"({op.count} calls, {op.avg_us:.1f}us avg, {op.pct:.1f}% "
                "of device op time)",
                _SUGGESTIONS[BottleneckType.MEMORY][:2]
                + _SUGGESTIONS[BottleneckType.COMPUTE][:1])
            for op in top
        ]
        covered = (min(1.0, table.total_us / 1e6 / wall_s)
                   if wall_s else 1.0)
        if wall_s and covered < 0.7:
            bottlenecks.append(Bottleneck(
                BottleneckType.OVERHEAD, 1.0 - covered,
                f"device ops cover only {covered:.0%} of wall time — "
                "dispatch gaps or host work dominate",
                _SUGGESTIONS[BottleneckType.OVERHEAD]))
        metrics = {
            "device_op_time_ms": table.total_us / 1e3,
            "wall_time_ms": wall_s * 1e3,
            "op_coverage": covered,
            "num_ops": float(len(table.ops)),
        }
        return BottleneckReport(bottlenecks=bottlenecks, metrics=metrics)

    def analyze_profile(self, profile_results) -> BottleneckReport:
        """Classify a ProfileResults (wall time + XLA cost analysis)."""
        cost = profile_results.cost
        return self.analyze(
            wall_time_s=profile_results.mean_s,
            flops=cost.get("flops", 0.0),
            bytes_accessed=cost.get("bytes accessed", 0.0),
        )


def _per_op_bound(source: Any, compute: bool, min_pct: float,
                  kind: Optional[str]) -> List[str]:
    """Shared walk: classify each OpTable row by its own arithmetic
    intensity against the chip ridge point. ``source`` is an xplane OpTable
    / KernelProfileResults (per-op flops + bytes from the trace's XLA cost
    stats) or, legacy, a whole-executable cost dict."""
    peaks = device_peaks(kind)
    ridge = peaks.bf16_flops / peaks.hbm_bytes_per_s
    table = getattr(source, "table", source)
    ops = getattr(table, "ops", None)
    if ops is None:  # whole-executable cost dict (jit(...).cost_analysis())
        flops = source.get("flops", 0.0)
        bytes_ = source.get("bytes accessed", 0.0)
        if not bytes_:
            return []
        is_compute = flops / bytes_ >= ridge
        return ["executable"] if is_compute == compute else []
    out = []
    for op in ops:
        if op.pct < min_pct:
            continue
        if not op.bytes_accessed:
            continue  # trace carried no cost stats for this op
        is_compute = op.flops / op.bytes_accessed >= ridge
        if is_compute == compute:
            out.append(op.name)
    return out


def identify_compute_bound_ops(source: Any, min_pct: float = 1.0,
                               threshold: float = 10.0,
                               kind: Optional[str] = None) -> List[str]:
    """Names of ops whose arithmetic intensity puts them above the ridge
    point of device ``kind`` (tensor-core-bound). Accepts an xplane ``OpTable`` /
    ``KernelProfileResults`` — per-op flops and bytes come from the XLA
    cost stats in the device trace — or a whole-executable cost dict
    (parity: bottleneck_analyzer.py:330-384)."""
    return _per_op_bound(source, compute=True, min_pct=min_pct, kind=kind)


def identify_memory_bound_ops(source: Any, min_pct: float = 1.0,
                              kind: Optional[str] = None) -> List[str]:
    """Names of ops below the ridge point (memory-bound); same sources as
    :func:`identify_compute_bound_ops` (parity:
    bottleneck_analyzer.py:386-440)."""
    return _per_op_bound(source, compute=False, min_pct=min_pct, kind=kind)
