"""Automatic parallelism configuration: cost model + search.

Rebuild of /root/reference/parallelism/auto_config.py (ParallelismCostModel
:19-518, AutoParallelConfig :520-843): exhaustive search over (tp, sp, pp,
dp) factorizations of the device count, scored by an analytic model.
Hardware numbers come from the device-kind peak table
(:mod:`mlio_tpu.utils.peaks`) instead of CUDA-capability guesses
(auto_config.py:559-593). The cards of one host are joined all to all by
NVLink, so every group's collectives run at the per-card link rate and the
mesh layout follows the algorithm alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax

from mlio_tpu.models.spec import ModelSpec
from mlio_tpu.parallel.collectives import estimate_collective_time
from mlio_tpu.utils.peaks import DEFAULT_KIND, device_peaks


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    kind: str = DEFAULT_KIND  # jax.Device.device_kind
    num_chips: int = 8

    @property
    def peak_tflops(self) -> float:
        return device_peaks(self.kind).bf16_flops / 1e12

    @property
    def hbm_gb(self) -> float:
        return device_peaks(self.kind).hbm_bytes / 1e9

    @property
    def hbm_gbps(self) -> float:
        return device_peaks(self.kind).hbm_bytes_per_s / 1e9

    @property
    def link_gbps(self) -> float:
        return device_peaks(self.kind).link_bytes_per_s / 1e9


def detect_hardware() -> HardwareSpec:
    """(parity: hardware detection auto_config.py:559-593). The device
    kind must be in the peak table."""
    devices = jax.devices()
    device_peaks(devices[0].device_kind)
    return HardwareSpec(kind=devices[0].device_kind, num_chips=len(devices))


@dataclasses.dataclass(frozen=True)
class CandidatePlan:
    tp: int = 1
    sp: int = 1
    pp: int = 1
    dp: int = 1

    @property
    def world(self) -> int:
        return self.tp * self.sp * self.pp * self.dp


class ParallelismCostModel:
    """Analytic step-time + memory model
    (parity: ParallelismCostModel auto_config.py:19-518)."""

    def __init__(self, spec: ModelSpec, hw: HardwareSpec,
                 *, dtype_bytes: int = 2):
        self.spec = spec
        self.hw = hw
        self.dtype_bytes = dtype_bytes

    # -- components ----------------------------------------------------------

    def flops_per_token(self) -> float:
        """Forward FLOPs/token ≈ 2 * params (the reference's 6h²/layer is
        the same quantity for its models, auto_config.py:128-176)."""
        return 2.0 * self.spec.num_params()

    def compute_time(self, plan: CandidatePlan, batch: int,
                     seq_len: int) -> float:
        """(parity: auto_config.py:128-228 incl. efficiency factors)."""
        tokens = batch * seq_len / max(1, plan.dp)
        flops = self.flops_per_token() * tokens / max(1, plan.tp * plan.sp)
        eff = 0.55  # achievable MFU for transformer prefill
        eff *= {1: 1.0}.get(plan.tp, 0.95)      # TP efficiency factor
        eff *= {1: 1.0}.get(plan.pp, 0.9)       # PP bubble cost
        return flops / (self.hw.peak_tflops * 1e12 * eff)

    def memory_per_chip(self, plan: CandidatePlan, batch: int,
                        seq_len: int) -> float:
        """Bytes per chip (parity: auto_config.py:230-330)."""
        params = self.spec.num_params() * self.dtype_bytes
        params_per = params / max(1, plan.tp * plan.pp)
        kv = (2 * self.spec.num_layers * seq_len * self.spec.kv_dim
              * self.dtype_bytes * batch)
        kv_per = kv / max(1, plan.tp * plan.sp * plan.pp) / max(1, plan.dp)
        act = (batch / max(1, plan.dp)) * (seq_len / max(1, plan.sp)) \
            * self.spec.hidden_size * self.dtype_bytes * 8
        return params_per + kv_per + act

    def communication_time(self, plan: CandidatePlan, batch: int,
                           seq_len: int) -> float:
        """(parity: auto_config.py:332-463). Per layer: TP does 2 all-reduces
        of the activation; SP-ring rotates K/V sp-1 times; PP sends one
        activation per microbatch boundary; DP is inference-free."""
        spec = self.spec
        act_bytes = (batch / max(1, plan.dp)) * (seq_len / max(1, plan.sp)) \
            * spec.hidden_size * self.dtype_bytes
        link = self.hw.link_gbps
        t = 0.0
        if plan.tp > 1:
            t += 2 * spec.num_layers * estimate_collective_time(
                int(act_bytes), plan.tp, collective="all_reduce",
                link_gbps=link)
        if plan.sp > 1:
            kv_bytes = 2 * (seq_len / plan.sp) * spec.kv_dim \
                * self.dtype_bytes * (batch / max(1, plan.dp))
            t += spec.num_layers * (plan.sp - 1) * estimate_collective_time(
                int(kv_bytes), plan.sp, collective="ppermute",
                link_gbps=link)
        if plan.pp > 1:
            t += (plan.pp - 1) * act_bytes / (link * 1e9)
        return t

    # -- scoring -------------------------------------------------------------

    def step_time(self, plan: CandidatePlan, batch: int,
                  seq_len: int) -> float:
        return (self.compute_time(plan, batch, seq_len)
                + self.communication_time(plan, batch, seq_len))

    def score(self, plan: CandidatePlan, batch: int, seq_len: int) -> float:
        """Lower is better; infeasible plans score inf
        (parity: auto_config.py:465-518)."""
        mem = self.memory_per_chip(plan, batch, seq_len)
        if mem > self.hw.hbm_gb * 1e9 * 0.9:
            return float("inf")
        t = self.step_time(plan, batch, seq_len)
        # mild preference for powers of two (auto_config.py:595-770)
        for d in (plan.tp, plan.sp, plan.pp, plan.dp):
            if d & (d - 1):
                t *= 1.05
        return t


def _factorizations(n: int) -> List[Tuple[int, int, int, int]]:
    out = []
    for tp in _divisors(n):
        for sp in _divisors(n // tp):
            rem = n // tp // sp
            for pp in _divisors(rem):
                dp = rem // pp
                out.append((tp, sp, pp, dp))
    return out


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


@dataclasses.dataclass
class AutoParallelConfig:
    """Search driver (parity: AutoParallelConfig auto_config.py:520-843)."""

    spec: ModelSpec
    hw: Optional[HardwareSpec] = None
    max_pp: int = 8  # (parity: pp<=8 rule parallel_utils.py:876)

    def __post_init__(self):
        if self.hw is None:
            self.hw = detect_hardware()

    def model_requirements(self, batch: int, seq_len: int) -> Dict[str, float]:
        """(parity: auto_config.py:772-843)."""
        model = ParallelismCostModel(self.spec, self.hw)
        single = CandidatePlan()
        return {
            "params_bytes": self.spec.num_params() * 2,
            "single_chip_memory_bytes": model.memory_per_chip(
                single, batch, seq_len),
            "fits_single_chip": model.memory_per_chip(single, batch, seq_len)
            < self.hw.hbm_gb * 1e9 * 0.9,
            "flops_per_token": model.flops_per_token(),
        }

    def search(self, batch: int = 8, seq_len: int = 2048,
               top_k: int = 5) -> List[Tuple[CandidatePlan, float]]:
        """Exhaustive scored search (parity: auto_config.py:595-770)."""
        model = ParallelismCostModel(self.spec, self.hw)
        results = []
        for tp, sp, pp, dp in _factorizations(self.hw.num_chips):
            if pp > self.max_pp or pp > self.spec.num_layers:
                continue
            if self.spec.num_kv_heads % tp and tp % self.spec.num_kv_heads:
                continue
            if self.spec.num_heads % tp:
                continue
            if seq_len % sp:
                continue
            plan = CandidatePlan(tp, sp, pp, dp)
            results.append((plan, model.score(plan, batch, seq_len)))
        results.sort(key=lambda r: r[1])
        return results[:top_k]

    def best_plan(self, batch: int = 8, seq_len: int = 2048) -> CandidatePlan:
        res = self.search(batch, seq_len, top_k=1)
        if not res or res[0][1] == float("inf"):
            raise ValueError("no feasible parallelism plan found "
                             "(model too large for this slice?)")
        return res[0][0]
