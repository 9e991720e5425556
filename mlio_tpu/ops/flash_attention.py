"""Fused (flash) attention through cuDNN.

Prefill attention at serving lengths is compute-bound, and cuDNN's fused
attention is already a Hopper kernel, so the flash path hands the call to
``jax.nn.dot_product_attention(implementation="cudnn")``. This module maps
the repository's attention arguments onto that call:

  * ``causal`` with ``q_offset == 0`` (a Python int) is cuDNN's own causal
    mask: query i sees keys 0..i;
  * a nonzero or traced ``q_offset`` (a chunk or a decode step placed after
    cached context) becomes an explicit boolean mask, query i seeing keys
    0..q_offset+i, because cuDNN's causal mask is aligned to key 0;
  * ``kv_len`` (scalar or [B]) becomes ``key_value_seq_lengths``.

cuDNN takes bf16/fp16 inputs with a head dim that is a multiple of 8; other
inputs raise. The reference path (:func:`mlio_tpu.ops.attention_reference`)
keeps the extras: int8 KV dequant, dropout, user masks, bias and the softmax
matrix. ``interpret=True`` maps the same arguments onto XLA's implementation
of the call, which is how the mapping is tested without a card.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def flash_attention(q, k, v, *, causal: bool = True, scale=None, q_offset=0,
                    kv_len=None, interpret: bool = False) -> jax.Array:
    """q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] → [B, Sq, Hq, D]."""
    B, Sq = q.shape[:2]
    Skv = k.shape[1]
    lens = None
    if kv_len is not None:
        lens = jnp.broadcast_to(jnp.asarray(kv_len, jnp.int32), (B,))
    mask = None
    is_causal = False
    if causal:
        if isinstance(q_offset, int) and q_offset == 0:
            is_causal = True
        else:
            mask = (jnp.arange(Sq)[:, None] + q_offset
                    >= jnp.arange(Skv)[None, :])[None, None]
    return jax.nn.dot_product_attention(
        q, k, v, mask=mask, scale=scale, is_causal=is_causal,
        key_value_seq_lengths=lens,
        implementation="xla" if interpret else "cudnn")
