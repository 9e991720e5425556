"""Unified configuration schema (stdlib dataclasses).

Capability parity with the reference's pydantic tree
(/root/reference/config/config_schema.py:5-83) plus the per-subsystem
dataclass configs scattered through the reference
(FlashAttentionConfig, RingAttentionConfig, TensorParallelConfig,
SequenceParallelConfig, ParallelConfig, BenchmarkConfig, ProfilerConfig) —
unified here into one validated tree: device meshes instead of GPU counts
and process groups, ``Impl`` kernel choices instead of Triton flags.

Every section validates its fields when it is built; :meth:`from_dict`
builds the tree from plain JSON data and rejects unknown keys.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


def _at_least(obj, minimum, *names):
    for name in names:
        if getattr(obj, name) < minimum:
            raise ValueError(f"{type(obj).__name__}.{name} must be >= "
                             f"{minimum}, got {getattr(obj, name)}")


def _one_of(obj, name, choices):
    if getattr(obj, name) not in choices:
        raise ValueError(f"{type(obj).__name__}.{name} must be one of "
                         f"{choices}, got {getattr(obj, name)!r}")


@dataclasses.dataclass
class HardwareConfig:
    """Target hardware description (reference: config_schema.py:5-12)."""

    platform: str = "gpu"  # "gpu" | "cpu" (cpu = virtual-device testing)
    num_chips: int = 1
    num_hosts: int = 1
    chip_type: str = "NVIDIA H100 80GB HBM3"  # device kind, see utils.peaks
    hbm_gb_per_chip: float = 80.0
    memory_fraction: float = 0.9

    def __post_init__(self):
        _one_of(self, "platform", ("gpu", "cpu"))
        _at_least(self, 1, "num_chips", "num_hosts")
        if not 0.0 < self.memory_fraction <= 1.0:
            raise ValueError("HardwareConfig.memory_fraction must be in "
                             f"(0, 1], got {self.memory_fraction}")


@dataclasses.dataclass
class KernelConfig:
    """Which compute-path implementation to use
    (reference: config_schema.py:13-21 + FlashAttentionConfig
    flash_attention.py:53-104); ``attention`` maps onto ``Impl``."""

    attention: str = "dense"  # "dense" | "flash" | "ring"
    causal: bool = True
    precision: str = "bf16"  # "fp32" | "bf16" | "fp16"

    def __post_init__(self):
        _one_of(self, "attention", ("dense", "flash", "ring"))
        _one_of(self, "precision", ("fp32", "bf16", "fp16"))


@dataclasses.dataclass
class QuantizationConfig:
    """Weight / KV-cache quantization (reference: int8/int4 paths,
    baseline/inference.py:467-557)."""

    weights: str = "none"  # "none" | "int8" | "int4" | "fp8"
    kv_cache: str = "none"  # "none" | "int8"
    activation: str = "none"  # "none" | "int8"
    per_channel: bool = True
    calibration_samples: int = 16

    def __post_init__(self):
        _one_of(self, "weights", ("none", "int8", "int4", "fp8"))
        _one_of(self, "kv_cache", ("none", "int8"))
        _one_of(self, "activation", ("none", "int8"))


@dataclasses.dataclass
class ParallelismConfig:
    """Mesh layout (reference: ParallelConfig orchestrator.py:20-120)."""

    tensor_parallel_size: int = 1
    sequence_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    data_parallel_size: int = 1
    expert_parallel_size: int = 1
    sequence_strategy: str = "ring"  # "local" | "ring" | "full" | "ulysses"
    communication_dtype: str = "bf16"
    auto: bool = False  # run the auto-config search instead

    def __post_init__(self):
        _at_least(self, 1, "tensor_parallel_size", "sequence_parallel_size",
                  "pipeline_parallel_size", "data_parallel_size",
                  "expert_parallel_size")

    @property
    def world_size(self) -> int:
        return (
            self.tensor_parallel_size
            * self.sequence_parallel_size
            * self.pipeline_parallel_size
            * self.data_parallel_size
        )


@dataclasses.dataclass
class ModelConfig:
    """Which model to run (reference: config_schema.py:32-43)."""

    name: str = "gpt2"
    checkpoint_path: Optional[str] = None  # local dir with HF weights
    dtype: str = "bf16"
    max_seq_len: int = 1024
    use_kv_cache: bool = True
    use_paged_kv_cache: bool = False
    kv_block_size: int = 16


@dataclasses.dataclass
class BenchmarkConfig:
    """(reference: config_schema.py:44-54 + benchmarks/runners.py:28-50)."""

    batch_sizes: List[int] = dataclasses.field(default_factory=lambda: [1, 8])
    seq_lens: List[int] = dataclasses.field(
        default_factory=lambda: [128, 1024])
    warmup_iters: int = 3
    iters: int = 10
    validate_outputs: bool = True
    rtol: float = 1e-3
    atol: float = 1e-3
    output_dir: str = "benchmark_results"


@dataclasses.dataclass
class ProfilingConfig:
    """(reference: config_schema.py:55-64 + ProfilerConfig
    torch_profiler.py:18-52)."""

    enabled: bool = False
    trace_dir: str = "profiles"
    capture_memory: bool = True
    cost_analysis: bool = True
    num_steps: int = 5


@dataclasses.dataclass
class DashboardConfig:
    """(reference: config_schema.py:65-72)."""

    enabled: bool = False
    host: str = "127.0.0.1"
    port: int = 8050
    results_dir: str = "benchmark_results"


_SECTIONS = {
    "hardware": HardwareConfig,
    "kernels": KernelConfig,
    "quantization": QuantizationConfig,
    "parallelism": ParallelismConfig,
    "model": ModelConfig,
    "benchmark": BenchmarkConfig,
    "profiling": ProfilingConfig,
    "dashboard": DashboardConfig,
}


@dataclasses.dataclass
class OptimizerConfig:
    """Root config (reference: config_schema.py:73-83)."""

    hardware: HardwareConfig = dataclasses.field(default_factory=HardwareConfig)
    kernels: KernelConfig = dataclasses.field(default_factory=KernelConfig)
    quantization: QuantizationConfig = dataclasses.field(
        default_factory=QuantizationConfig)
    parallelism: ParallelismConfig = dataclasses.field(
        default_factory=ParallelismConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    benchmark: BenchmarkConfig = dataclasses.field(
        default_factory=BenchmarkConfig)
    profiling: ProfilingConfig = dataclasses.field(
        default_factory=ProfilingConfig)
    dashboard: DashboardConfig = dataclasses.field(
        default_factory=DashboardConfig)

    def __post_init__(self):
        self.validate()

    def validate(self) -> "OptimizerConfig":
        """Cross-section check: the mesh must fit the available chips."""
        world = self.parallelism.world_size
        chips = self.hardware.num_chips * self.hardware.num_hosts
        if not self.parallelism.auto and world > chips:
            raise ValueError(
                f"parallelism world size {world} exceeds available chips {chips}"
            )
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "OptimizerConfig":
        unknown = set(raw) - set(_SECTIONS)
        if unknown:
            raise ValueError(f"unknown config sections: {sorted(unknown)}")
        sections = {}
        for name, section_cls in _SECTIONS.items():
            values = raw.get(name) or {}
            known = {f.name for f in dataclasses.fields(section_cls)}
            bad = set(values) - known
            if bad:
                raise ValueError(f"unknown keys in '{name}': {sorted(bad)}")
            sections[name] = section_cls(**values)
        return cls(**sections)
