"""Deterministic position-hashed attention dropout.

Parity: the reference's FlashAttentionConfig.dropout / fused-kernel dropout
(/root/reference/kernels/attention/flash_attention.py:53-104,
kernels/triton/flash_attention_kernels.py:347-684 dropout path). The
keep/drop decision is a **stateless integer hash of the absolute (query
position, key position, batch, head, seed)**. Properties that matter:

  * the mask does not depend on how a computation tiles the score matrix
    (the hash sees absolute positions), so forward and backward, and a
    chunked and an unchunked evaluation, drop the same elements;
  * tests compare against a fixed mask exactly, not statistically;
  * pure int32 mul/xor/shift vector ops, on any backend.

The hash is two rounds of a murmur3-style finalizer over a linear mix of
the coordinates; avalanche quality is far beyond what dropout needs.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def _i32(x: int) -> jnp.int32:
    return jnp.int32(np.int32(np.uint32(x & 0xFFFFFFFF)))


def _mix(h):
    h = h ^ lax.shift_right_logical(h, 16)
    h = h * _i32(0x7FEB352D)
    h = h ^ lax.shift_right_logical(h, 15)
    h = h * _i32(0x846CA68B)
    h = h ^ lax.shift_right_logical(h, 16)
    return h


def keep_u01(i, j, seed):
    """Uniform-ish [0, 1) f32 from int32 coordinate grids ``i``, ``j`` and a
    scalar ``seed`` (which should already fold in batch/head)."""
    i = jnp.asarray(i, jnp.int32)
    j = jnp.asarray(j, jnp.int32)
    h = (i * _i32(0x9E3779B9)) ^ (j * _i32(0x85EBCA6B))
    h = h + jnp.asarray(seed, jnp.int32) * _i32(0xC2B2AE35)
    h = _mix(h)
    return (h & jnp.int32(0x7FFFFF)).astype(jnp.float32) * jnp.float32(
        1.0 / (1 << 23))


def fold_seed(seed, b, h):
    """Fold batch/head indices into the seed so masks decorrelate across
    (b, h) — scalars or int arrays."""
    return (jnp.asarray(seed, jnp.int32)
            + jnp.asarray(b, jnp.int32) * jnp.int32(131071)
            + jnp.asarray(h, jnp.int32) * jnp.int32(8191))


def keep_mask(i, j, seed, rate: float):
    """Boolean keep mask over broadcastable int32 position grids."""
    return keep_u01(i, j, seed) >= jnp.float32(rate)


def dense_keep_mask(B: int, Hq: int, Sq: int, Skv: int, seed,
                    rate: float, q_offset=0):
    """[B, Hq, Sq, Skv] keep mask — the jnp twin used by
    ops.reference.attention_reference and by tests for exact comparison."""
    i = (jnp.arange(Sq, dtype=jnp.int32) + jnp.asarray(q_offset, jnp.int32)
         )[None, None, :, None]
    j = jnp.arange(Skv, dtype=jnp.int32)[None, None, None, :]
    b = jnp.arange(B, dtype=jnp.int32)[:, None, None, None]
    h = jnp.arange(Hq, dtype=jnp.int32)[None, :, None, None]
    return keep_u01(i, j, fold_seed(seed, b, h)) >= jnp.float32(rate)
