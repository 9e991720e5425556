"""mlio_tpu — inference optimization framework for NVIDIA Hopper GPUs.

A ground-up JAX/XLA/Pallas re-design of the capability surface of the
reference GPU framework ``aslitaser/ml-inference-optimizer`` (see SURVEY.md):
functional transformer runtime (GPT-2 / Llama families), cuDNN fused
attention, a Pallas-Triton paged decode kernel, ring attention, INT8
weight-only and KV-cache quantization, mesh-based tensor/sequence
parallelism, profiling, benchmarking and reporting.

Unlike the reference (which monkeypatches PyTorch modules at runtime,
cf. /root/reference/baseline/inference.py:283, model_utils.py:600), every
optimization here is a compile-time choice: which kernel implementation,
which sharding — expressed through :class:`mlio_tpu.models.Impl` and
``jax.sharding.NamedSharding`` over a device mesh.
"""

__version__ = "0.1.0"

from mlio_tpu.config import OptimizerConfig, load_config, save_config, merge_configs
from mlio_tpu.models import ModelSpec, Impl

__all__ = [
    "OptimizerConfig",
    "load_config",
    "save_config",
    "merge_configs",
    "ModelSpec",
    "Impl",
    "__version__",
]
