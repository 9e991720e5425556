"""JSON config load / save / merge / hardware-aware auto-defaults.

Capability parity with /root/reference/config/config_loader.py:12-134.
The auto-optimization heuristics: TP spans the cards of one host (joined all
to all by NVLink), sequence parallelism turns on for long contexts, bf16 is
the default compute dtype.
"""
from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Dict, Optional, Union

from mlio_tpu.config.schema import OptimizerConfig


def load_config(path: Union[str, Path, None] = None) -> OptimizerConfig:
    """Load a JSON config file into a validated :class:`OptimizerConfig`.

    Reference parity: config_loader.py:12-43. A ``None`` path returns the
    defaults.
    """
    if path is None:
        return OptimizerConfig()
    raw = json.loads(Path(path).read_text() or "{}")
    return OptimizerConfig.from_dict(raw)


def save_config(config: OptimizerConfig, path: Union[str, Path]) -> None:
    """Persist the effective config (reference: config_loader.py:45-62)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(config.to_dict(), indent=2) + "\n")


def merge_configs(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive dict merge, override wins (reference: config_loader.py:64-88)."""
    merged = copy.deepcopy(base)
    for key, value in override.items():
        if key in merged and isinstance(merged[key], dict) and isinstance(value, dict):
            merged[key] = merge_configs(merged[key], value)
        else:
            merged[key] = copy.deepcopy(value)
    return merged


def get_optimized_config(
    model_name: str = "gpt2",
    num_chips: Optional[int] = None,
    num_hosts: int = 1,
    max_seq_len: Optional[int] = None,
) -> OptimizerConfig:
    """Hardware-aware auto defaults (reference: config_loader.py:91-134).

    Heuristics:
      * TP = min(num_chips, 8) — keep the TP group inside one host.
      * Remaining chips become data parallel.
      * Sequence parallelism (ring attention) for contexts >= 16K.
      * bf16 compute everywhere.
    """
    import jax

    if num_chips is None:
        try:
            num_chips = jax.local_device_count()
        except Exception:  # pragma: no cover - no backend available
            num_chips = 1

    cfg = OptimizerConfig()
    cfg.model.name = model_name
    if max_seq_len is not None:
        cfg.model.max_seq_len = max_seq_len
    cfg.hardware.num_chips = num_chips
    cfg.hardware.num_hosts = num_hosts

    total = num_chips * num_hosts
    tp = min(total, 8)
    while total % tp != 0:
        tp -= 1
    cfg.parallelism.tensor_parallel_size = tp
    long_context = (max_seq_len or cfg.model.max_seq_len) >= 16384
    if long_context and total // tp > 1:
        sp = total // tp
        cfg.parallelism.sequence_parallel_size = sp
        cfg.parallelism.sequence_strategy = "ring"
    else:
        cfg.parallelism.data_parallel_size = total // tp

    cfg.model.dtype = "bf16"
    cfg.kernels.precision = "bf16"
    return cfg.validate()
