"""Published peak rates of the devices the program runs on, by device kind.

The one table every roofline, utilization and cost-model number divides by.
Keys are ``jax.Device.device_kind`` strings. A device kind that is not here
is an error: a peak is never assumed.

Sources:
  * NVIDIA H100 SXM5 80GB: NVIDIA H100 Tensor Core GPU data sheet, dense
    rates without sparsity, at the 700 W power limit: 989 TFLOP/s bf16,
    1,979 TFLOP/s fp8, 1,979 TOP/s int8, 3.35 TB/s HBM3, 80 GB, NVLink
    900 GB/s total to the other cards of the host (450 GB/s each way).
    A card set below 700 W (``nvidia-smi --query-gpu=power.limit``) cannot
    hold its top clock under a matrix-heavy load.
  * cpu: the virtual-device test platform (``JAX_PLATFORMS=cpu``). Nominal
    figures that let the cost model run in tests; not a measurement of
    anything.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    bf16_flops: float          # FLOP/s, dense
    int8_ops: float            # OP/s, dense
    fp8_flops: float           # FLOP/s, dense
    hbm_bytes_per_s: float
    hbm_bytes: float
    link_bytes_per_s: float    # to each other card, one direction
    chips_per_host: int


_H100_SXM = DevicePeaks(bf16_flops=989e12, int8_ops=1979e12, fp8_flops=1979e12,
                        hbm_bytes_per_s=3.35e12, hbm_bytes=80e9,
                        link_bytes_per_s=450e9, chips_per_host=8)

PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
    "cpu": DevicePeaks(bf16_flops=0.2e12, int8_ops=0.4e12, fp8_flops=0.2e12,
                       hbm_bytes_per_s=50e9, hbm_bytes=8e9,
                       link_bytes_per_s=10e9, chips_per_host=8),
}

DEFAULT_KIND = "NVIDIA H100 80GB HBM3"


def device_peaks(kind: Optional[str] = None) -> DevicePeaks:
    """Peaks for ``kind`` (default: the first JAX device's kind).

    Raises KeyError for a device kind the table does not know."""
    if kind is None:
        kind = jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(PEAKS)}") from None
