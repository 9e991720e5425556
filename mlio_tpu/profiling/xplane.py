"""Per-op device-time tables from ``jax.profiler.trace`` captures.

Rebuild of the reference's kernel profiler
(/root/reference/profiling/kernel_profiler.py:22-161 — per-kernel time
tables, slow-kernel filter, occupancy analysis). The ground truth is
the XLA profiler's XSpace protobuf (``*.xplane.pb`` under
``<trace_dir>/plugins/profile/<run>/``): device planes carry one line per
XLA module plus an "XLA Ops" line whose events are the individual fused
ops/kernels with picosecond timings.

No TensorFlow dependency is available in this image, so this module decodes
the protobuf wire format directly against the (stable, public) xplane.proto
schema — field numbers below mirror
tensorflow/core/profiler/protobuf/xplane.proto.
"""
from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = [
    "OpStats",
    "OpTable",
    "parse_xspace",
    "latest_xspace_path",
    "op_table_from_trace",
]


# ---------------------------------------------------------------------------
# Protobuf wire-format primitives (decode only, unknown fields skipped)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = _read_varint(buf, pos)
        return pos
    if wire_type == 1:  # 64-bit
        return pos + 8
    if wire_type == 2:  # length-delimited
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire_type == 5:  # 32-bit
        return pos + 4
    raise ValueError(f"unsupported wire type {wire_type}")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a serialized message.

    value is int for varint, bytes for length-delimited, raw bytes for
    fixed32/64 (callers that need floats unpack themselves).
    """
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            pos = _skip_field(buf, pos, wire)
            continue
        yield field, wire, val


def _zigzag_ok_int(v: int) -> int:
    # xplane uses plain int64 (not sint64); two's-complement for negatives.
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# XSpace object model (only what the op table needs)


@dataclasses.dataclass
class XEvent:
    metadata_id: int
    offset_ps: int
    duration_ps: int
    num_occurrences: int = 0
    stats: Dict[int, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class XLine:
    name: str
    events: List[XEvent]


@dataclasses.dataclass
class XPlane:
    name: str
    lines: List[XLine]
    event_names: Dict[int, str]          # metadata_id -> op name
    event_display: Dict[int, str]        # metadata_id -> display name (fused op)
    stat_names: Dict[int, str] = dataclasses.field(default_factory=dict)
    # metadata_id -> {stat_metadata_id: numeric value} (per-op-kind stats —
    # XLA attaches "flops" / "bytes accessed" here on device planes)
    event_meta_stats: Dict[int, Dict[int, float]] = dataclasses.field(
        default_factory=dict)


def _unpack_f64(raw: bytes) -> float:
    import struct

    return struct.unpack("<d", raw)[0]


def _parse_stat(buf: bytes) -> Tuple[int, Optional[float]]:
    """XStat: metadata_id=1; value oneof double=2(fixed64) / uint64=3 /
    int64=4 / str=5 / bytes=6 / ref=7. Returns numeric value or None."""
    mid, val = 0, None
    for field, wire, v in _fields(buf):
        if field == 1:
            mid = v
        elif field == 2 and wire == 1:
            val = _unpack_f64(v)
        elif field == 3 and wire == 0:
            val = float(v)
        elif field == 4 and wire == 0:
            val = float(_zigzag_ok_int(v))
    return mid, val


def _parse_event(buf: bytes) -> XEvent:
    ev = XEvent(0, 0, 0)
    for field, _, val in _fields(buf):
        if field == 1:
            ev.metadata_id = val
        elif field == 2:
            ev.offset_ps = _zigzag_ok_int(val)
        elif field == 3:
            ev.duration_ps = _zigzag_ok_int(val)
        elif field == 5:
            ev.num_occurrences = val
        elif field == 4:
            mid, v = _parse_stat(val)
            if v is not None:
                ev.stats[mid] = v
    return ev


def _parse_line(buf: bytes) -> XLine:
    name = ""
    display = ""
    events: List[XEvent] = []
    for field, _, val in _fields(buf):
        if field == 2:
            name = val.decode("utf-8", "replace")
        elif field == 11:
            display = val.decode("utf-8", "replace")
        elif field == 4:
            events.append(_parse_event(val))
    return XLine(display or name, events)


def _parse_event_metadata(buf: bytes) -> Tuple[int, str, str,
                                               Dict[int, float]]:
    mid, name, display = 0, "", ""
    stats: Dict[int, float] = {}
    for field, _, val in _fields(buf):
        if field == 1:
            mid = val
        elif field == 2:
            name = val.decode("utf-8", "replace")
        elif field == 4:
            display = val.decode("utf-8", "replace")
        elif field == 5:  # repeated XStat (per-op-kind, e.g. flops)
            smid, v = _parse_stat(val)
            if v is not None:
                stats[smid] = v
    return mid, name, display, stats


def _parse_stat_metadata(buf: bytes) -> Tuple[int, str]:
    mid, name = 0, ""
    for field, _, val in _fields(buf):
        if field == 1:
            mid = val
        elif field == 2:
            name = val.decode("utf-8", "replace")
    return mid, name


def _parse_plane(buf: bytes) -> XPlane:
    name = ""
    lines: List[XLine] = []
    event_names: Dict[int, str] = {}
    event_display: Dict[int, str] = {}
    stat_names: Dict[int, str] = {}
    event_meta_stats: Dict[int, Dict[int, float]] = {}
    for field, _, val in _fields(buf):
        if field == 2:
            name = val.decode("utf-8", "replace")
        elif field == 3:
            lines.append(_parse_line(val))
        elif field == 4:
            # map<int64, XEventMetadata>: entry {key=1 varint, value=2 msg}
            key, meta = None, None
            for f2, _, v2 in _fields(val):
                if f2 == 1:
                    key = v2
                elif f2 == 2:
                    meta = v2
            if meta is not None:
                mid, ename, edisp, estats = _parse_event_metadata(meta)
                k = key if key is not None else mid
                event_names[k] = ename
                if edisp:
                    event_display[k] = edisp
                if estats:
                    event_meta_stats[k] = estats
        elif field == 5:
            # map<int64, XStatMetadata>
            key, meta = None, None
            for f2, _, v2 in _fields(val):
                if f2 == 1:
                    key = v2
                elif f2 == 2:
                    meta = v2
            if meta is not None:
                smid, sname = _parse_stat_metadata(meta)
                stat_names[key if key is not None else smid] = sname
    return XPlane(name, lines, event_names, event_display, stat_names,
                  event_meta_stats)


def parse_xspace(path: str) -> List[XPlane]:
    """Parse an ``*.xplane.pb`` file into a list of planes."""
    with open(path, "rb") as f:
        buf = f.read()
    planes = []
    for field, _, val in _fields(buf):
        if field == 1:
            planes.append(_parse_plane(val))
    return planes


def latest_xspace_path(trace_dir: str) -> Optional[str]:
    """Newest xplane.pb under a ``jax.profiler.trace`` output directory."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    return max(paths, key=os.path.getmtime) if paths else None


# ---------------------------------------------------------------------------
# Per-op aggregation (the reference's kernel-stats table shape)


@dataclasses.dataclass
class OpStats:
    name: str
    count: int
    total_us: float
    avg_us: float
    pct: float           # share of summed device op time
    line: str            # which device line it came from
    flops: float = 0.0   # summed over occurrences (0 if trace lacks stats)
    bytes_accessed: float = 0.0

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / self.bytes_accessed if self.bytes_accessed \
            else float("inf") if self.flops else 0.0


@dataclasses.dataclass
class OpTable:
    device: str
    total_us: float
    ops: List[OpStats]

    def top(self, k: int = 10) -> List[OpStats]:
        return self.ops[:k]

    def slow_ops(self, threshold_us: float = 0.0,
                 min_pct: float = 0.0) -> List[OpStats]:
        """Reference parity: KernelProfileResults slow-kernel filter
        (/root/reference/profiling/kernel_profiler.py:96-120)."""
        return [o for o in self.ops
                if o.avg_us >= threshold_us and o.pct >= min_pct]

    def summary(self, k: int = 10) -> str:
        hdr = (f"device={self.device} total_device_time="
               f"{self.total_us / 1e3:.3f}ms\n")
        rows = [f"{'op':<48} {'count':>7} {'total_us':>10} "
                f"{'avg_us':>9} {'pct':>6}"]
        for o in self.top(k):
            nm = o.name if len(o.name) <= 48 else o.name[:45] + "..."
            rows.append(f"{nm:<48} {o.count:>7} {o.total_us:>10.1f} "
                        f"{o.avg_us:>9.2f} {o.pct:>5.1f}%")
        return hdr + "\n".join(rows)

    def to_json(self) -> dict:
        return {
            "device": self.device,
            "total_us": self.total_us,
            "ops": [dataclasses.asdict(o) for o in self.ops],
        }


_DEVICE_MARKERS = ("GPU", "/device:")
# Lines that time individual compiled ops rather than whole modules/steps.
_OP_LINE_NAMES = ("XLA Ops", "XLA TraceMe", "Tensorflow Ops")
# CPU traces put op events on the host plane under per-client lines.
_HOST_OP_LINE_PREFIXES = ("tf_XLA",)
# Runtime bookkeeping events interleaved with real op events (CPU thunks).
_INFRA_PREFIXES = ("end: ", "ThreadpoolListener", "SlinkyThreadPool",
                   "ThunkExecutor", "CommonPjRt", "PjRtCpu", "Handle inputs",
                   "ParseArguments")


def _is_device_plane(plane: XPlane) -> bool:
    return any(m in plane.name for m in _DEVICE_MARKERS) and \
        "Host" not in plane.name


def _op_lines(plane: XPlane, device: bool) -> List[XLine]:
    if device:
        lines = [ln for ln in plane.lines if ln.name in _OP_LINE_NAMES]
        return lines or [ln for ln in plane.lines
                         if "Step" not in ln.name and ln.events]
    return [ln for ln in plane.lines
            if ln.name.startswith(_HOST_OP_LINE_PREFIXES)]


def op_table_from_xspace(planes: List[XPlane],
                         device_substr: Optional[str] = None) -> OpTable:
    """Aggregate per-op device time across all device planes.

    Prefers op-granularity lines ("XLA Ops") on device planes; CPU-only
    traces fall back to the host plane's XLA-client thunk lines (real op
    durations, runtime bookkeeping events filtered out).
    """
    agg: Dict[Tuple[str, str], List[float]] = {}
    device_names: List[str] = []
    dev_planes = [p for p in planes if _is_device_plane(p)]
    host_fallback = not dev_planes
    candidates = dev_planes or [p for p in planes if "CPU" in p.name]
    for plane in candidates:
        if device_substr and device_substr not in plane.name:
            continue
        device_names.append(plane.name)
        # stat-metadata ids for the cost stats XLA attaches to op events
        flop_ids = {i for i, n in plane.stat_names.items()
                    if n in ("flops", "model_flops")}
        byte_ids = {i for i, n in plane.stat_names.items()
                    if n in ("bytes accessed", "bytes_accessed")}

        def cost_of(ev):
            stats = dict(plane.event_meta_stats.get(ev.metadata_id, {}))
            stats.update(ev.stats)  # event-level overrides op-kind-level
            fl = sum(v for i, v in stats.items() if i in flop_ids)
            by = sum(v for i, v in stats.items() if i in byte_ids)
            return fl, by

        for line in _op_lines(plane, device=not host_fallback):
            for ev in line.events:
                name = (plane.event_display.get(ev.metadata_id)
                        or plane.event_names.get(ev.metadata_id)
                        or f"op#{ev.metadata_id}")
                if name.startswith(_INFRA_PREFIXES):
                    continue
                key = (line.name, name)
                cell = agg.setdefault(key, [0, 0.0, 0.0, 0.0])
                occ = max(1, ev.num_occurrences)
                cell[0] += occ
                cell[1] += ev.duration_ps / 1e6  # ps -> us
                fl, by = cost_of(ev)
                cell[2] += fl * occ
                cell[3] += by * occ
    total = sum(v[1] for v in agg.values()) or 1.0
    ops = [OpStats(name=name, count=int(c), total_us=t,
                   avg_us=t / max(1, c), pct=100.0 * t / total, line=ln,
                   flops=fl, bytes_accessed=by)
           for (ln, name), (c, t, fl, by) in agg.items()]
    ops.sort(key=lambda o: -o.total_us)
    return OpTable(device=",".join(device_names) or "none",
                   total_us=total, ops=ops)


def op_table_from_trace(trace_dir: str,
                        device_substr: Optional[str] = None
                        ) -> Optional[OpTable]:
    """Parse the newest capture under ``trace_dir`` into a per-op table."""
    path = latest_xspace_path(trace_dir)
    if path is None:
        return None
    return op_table_from_xspace(parse_xspace(path), device_substr)
