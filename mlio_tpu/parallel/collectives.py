"""Collective communication primitives (shard_map-scoped).

Rebuild of /root/reference/parallelism/communication.py (1,865 LoC of
torch.distributed/NCCL plumbing) — here each primitive is ONE XLA op
inside shard_map, which XLA hands to NCCL, and everything the reference
hand-builds (stream overlap communication.py:502-578, tree all-reduce
:96-179, NCCL env tuning :886-1114, NVLink topology discovery :1116-1630,
pinned buffer pools :856) is owned by XLA's scheduler. The mapping table
(SURVEY.md §2.5):

    all_reduce      -> lax.psum / pmean
    all_gather      -> lax.all_gather
    reduce_scatter  -> lax.psum_scatter
    broadcast       -> implicit replication (or ppermute from root)
    ring_exchange   -> lax.ppermute around the ring
    all_to_all      -> lax.all_to_all (Ulysses)

These wrappers exist for API parity and for the on-the-wire dtype
compression option the reference applies (communication.py:70-74).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax


def _maybe_compress(x: jax.Array, comm_dtype) -> Tuple[jax.Array, object]:
    """bf16-on-the-wire compression (parity: communication.py:70-74)."""
    if comm_dtype is None or x.dtype == comm_dtype:
        return x, None
    return x.astype(comm_dtype), x.dtype


def all_reduce(x: jax.Array, axis: str, *, op: str = "sum",
               comm_dtype=None) -> jax.Array:
    """(parity: all_reduce communication.py:37-209, incl. the 'avg'
    special-case and wire compression)."""
    x, orig = _maybe_compress(x, comm_dtype)
    if op == "sum":
        out = lax.psum(x, axis)
    elif op in ("avg", "mean"):
        out = lax.pmean(x, axis)
    elif op == "max":
        out = lax.pmax(x, axis)
    elif op == "min":
        out = lax.pmin(x, axis)
    else:
        raise ValueError(f"unknown reduce op {op}")
    return out.astype(orig) if orig is not None else out


def all_gather(x: jax.Array, axis: str, *, dim: int = 0,
               comm_dtype=None) -> jax.Array:
    """Concatenate shards along ``dim`` (parity: communication.py:211-246)."""
    x, orig = _maybe_compress(x, comm_dtype)
    out = lax.all_gather(x, axis, axis=dim, tiled=True)
    return out.astype(orig) if orig is not None else out


def reduce_scatter(x: jax.Array, axis: str, *, dim: int = 0,
                   comm_dtype=None) -> jax.Array:
    """Sum-reduce then scatter along ``dim``
    (parity: communication.py:248-304)."""
    x, orig = _maybe_compress(x, comm_dtype)
    out = lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)
    return out.astype(orig) if orig is not None else out


def broadcast(x: jax.Array, axis: str, *, root: int = 0) -> jax.Array:
    """Every device gets root's shard (parity: communication.py:306-334).
    ppermute requires unique sources, so broadcast = mask-then-psum."""
    mask = lax.axis_index(axis) == root
    return lax.psum(jnp.where(mask, x, jnp.zeros_like(x)), axis)


def ring_exchange(*tensors: jax.Array, axis: str,
                  direction: int = 1) -> Tuple[jax.Array, ...]:
    """Send to rank+direction, receive from rank-direction — one ring
    rotation (parity: ring_exchange v2 communication.py:1694-1831; the
    recv-before-send deadlock dance collapses into one ppermute)."""
    sz = lax.axis_size(axis)
    perm = [(i, (i + direction) % sz) for i in range(sz)]
    out = tuple(lax.ppermute(t, axis, perm) for t in tensors)
    return out if len(out) > 1 else out[0]


def all_to_all(x: jax.Array, axis: str, *, split_dim: int,
               concat_dim: int) -> jax.Array:
    """Head<->sequence redistribution (Ulysses; absent in the reference —
    SURVEY.md §2.5 upgrade)."""
    return lax.all_to_all(x, axis, split_axis=split_dim,
                          concat_axis=concat_dim, tiled=True)


def barrier(axis: str) -> None:
    """Device barrier (parity: communication.py:366-374). Inside shard_map a
    psum of a scalar is a full synchronization point."""
    lax.psum(jnp.zeros((), jnp.int32), axis)


def estimate_collective_time(
    bytes_per_device: int,
    num_devices: int,
    *,
    collective: str = "all_reduce",
    link_gbps: float = 450.0,
) -> float:
    """Analytic collective-time model (replaces the reference's
    measured-bandwidth matrices communication.py:1222-1364). ``link_gbps``
    is one card's link rate in one direction; the default is an H100's
    NVLink share (mlio_tpu.utils.peaks).

    Ring algorithms: all_reduce moves 2(n-1)/n of the data, all_gather and
    reduce_scatter (n-1)/n, ppermute 1/n-th per step.
    """
    if num_devices <= 1:
        return 0.0
    n = num_devices
    factor = {
        "all_reduce": 2 * (n - 1) / n,
        "all_gather": (n - 1) / n,
        "reduce_scatter": (n - 1) / n,
        "ppermute": 1.0,
        "all_to_all": (n - 1) / n,
    }[collective]
    return bytes_per_device * factor / (link_gbps * 1e9)
