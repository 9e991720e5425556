"""Device utilities.

Rebuild of /root/reference/utils/gpu_utils.py:9-186 (get_gpu_memory_usage,
clear_gpu_memory, calculate_memory_needed, gpu_info_string,
is_enough_gpu_memory) against jax device APIs.
"""
from __future__ import annotations

import gc
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp


def get_device_memory_usage(device: Optional[jax.Device] = None) -> Dict[str, float]:
    """(parity: get_gpu_memory_usage gpu_utils.py:9-68)."""
    if device is None:
        device = jax.devices()[0]
    try:
        stats = device.memory_stats() or {}
    except Exception:
        stats = {}
    in_use = stats.get("bytes_in_use", 0)
    limit = stats.get("bytes_limit", 0)
    return {
        "bytes_in_use": in_use,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use", 0),
        "bytes_limit": limit,
        "gb_in_use": in_use / 1e9,
        "gb_free": max(0, limit - in_use) / 1e9,
        "utilization": in_use / limit if limit else 0.0,
    }


def clear_device_memory() -> None:
    """Drop cached buffers (parity: clear_gpu_memory gpu_utils.py:69-83).
    jax frees device buffers when their Arrays are collected; there is no
    explicit cache flush, so this forces a GC + live-array cleanup."""
    gc.collect()
    try:
        jax.clear_caches()
    except Exception:
        pass


def calculate_memory_needed(
    num_params: int,
    batch_size: int = 1,
    seq_len: int = 1024,
    hidden_size: int = 768,
    num_layers: int = 12,
    kv_dim: Optional[int] = None,
    dtype_bytes: int = 2,
) -> Dict[str, float]:
    """Analytic memory requirement (parity: gpu_utils.py:84-121)."""
    params_bytes = num_params * dtype_bytes
    kv = 2 * num_layers * batch_size * seq_len * (kv_dim or hidden_size) \
        * dtype_bytes
    act = batch_size * seq_len * hidden_size * dtype_bytes * 8
    total = params_bytes + kv + act
    return {"params_bytes": params_bytes, "kv_cache_bytes": kv,
            "activation_bytes": act, "total_bytes": total,
            "total_gb": total / 1e9}


def device_info_string() -> str:
    """(parity: gpu_info_string gpu_utils.py:122-163)."""
    lines = []
    for d in jax.devices():
        mem = get_device_memory_usage(d)
        lines.append(
            f"{d.id}: {d.device_kind} ({d.platform}) — "
            f"{mem['gb_in_use']:.2f} GB in use"
            + (f" / {mem['bytes_limit'] / 1e9:.1f} GB"
               if mem["bytes_limit"] else ""))
    return "\n".join(lines) or "no devices"


def is_enough_device_memory(required_bytes: int,
                            device: Optional[jax.Device] = None,
                            safety_factor: float = 1.1) -> bool:
    """(parity: is_enough_gpu_memory gpu_utils.py:165-186)."""
    mem = get_device_memory_usage(device)
    limit = mem["bytes_limit"]
    if not limit:  # unknown (CPU backend) — assume yes
        return True
    free = limit - mem["bytes_in_use"]
    return free >= required_bytes * safety_factor


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is left alone (JAX reads it
    itself) and no other directory is set in code. Otherwise the cache goes
    to ``<repo root>/.jax_cache``: a fixed path, because the path is part of
    the cache's key and a directory that moves never hits."""
    import os
    from pathlib import Path

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(Path(__file__).resolve().parents[2] / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
