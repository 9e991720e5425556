"""Model forward passes over the paged KV cache.

The serving-critical path (SURVEY.md §3.2): prefill computes each layer's
K/V, writes them into the paged pools via reshape_and_cache and attends over
the fresh K/V (ops.attention); decode reads non-contiguous context through
ops.paged_attention. Layer iteration is a lax.scan carrying the pools (pool
layer dim indexed by the traced layer id) — the equivalent of the
reference's per-layer monkeypatched forward
(/root/reference/baseline/model_utils.py:600-759
add_paged_attention_to_model).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from mlio_tpu import ops
from mlio_tpu.models.spec import ModelSpec
from mlio_tpu.models.transformer import (Impl, apply_rope, lm_logits,
                                          rope_cos_sin, _residual_tail,
                                          _split_heads, _qkv_proj)
from mlio_tpu.ops.paged_attention import reshape_and_cache


def _embed(params, spec, ids, positions):
    x = params["tok_embed"][ids]
    if spec.embed_scale is not None:
        x = x * jnp.asarray(spec.embed_scale, x.dtype)
    if spec.positional == "learned":
        x = x + params["pos_embed"][positions].astype(x.dtype)
        return x, (None, None)
    cos, sin = rope_cos_sin(positions, spec.rope_dim, spec.rope_theta)
    return x, (cos, sin)


@functools.partial(jax.jit, static_argnames=("spec", "impl"),
                   donate_argnums=(3, 4))
def prefill_paged(
    params,
    spec: ModelSpec,
    ids: jax.Array,           # [B, S] (padded; true lengths in seq_lens)
    k_pool: jax.Array,
    v_pool: jax.Array,
    block_tables: jax.Array,  # [B, max_blocks]
    seq_lens: jax.Array,      # [B] true prompt lengths
    write_pos: jax.Array,     # [B] absolute position of ids[:, 0] (0 for full prefill)
    *,
    impl: Impl = Impl(),
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Prefill: write K/V for all S positions, return last-valid-token logits.

    Returns (logits [B, V], k_pool, v_pool).
    """
    B, S = ids.shape
    positions = write_pos[:, None] + jnp.arange(S)[None, :]
    x, (cos, sin) = _embed(params, spec, ids, positions)

    def block_fn(carry, inputs):
        x, k_pool, v_pool = carry
        bp, layer = inputs
        h = ops.norm(x, bp["ln1_scale"], bp["ln1_bias"], kind=spec.norm,
                     eps=spec.norm_eps, impl=impl)
        qf, kf, vf = _qkv_proj(h, bp, spec, impl)
        q = _split_heads(qf, spec.num_heads)
        k = _split_heads(kf, spec.num_kv_heads)
        v = _split_heads(vf, spec.num_kv_heads)
        if cos is not None:
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        k_pool, v_pool = reshape_and_cache(k_pool, v_pool, k, v,
                                           block_tables, write_pos, layer)
        attn = ops.attention(q, k, v, causal=True, q_offset=0,
                             kv_len=seq_lens, impl=impl)
        attn_out = ops.linear(attn.reshape(B, S, spec.q_dim), bp["wo"],
                              bp["bo"], impl=impl)
        x = _residual_tail(x, attn_out, h, bp, spec, impl)
        return (x, k_pool, v_pool), None

    (x, k_pool, v_pool), _ = jax.lax.scan(
        block_fn, (x, k_pool, v_pool),
        (params["blocks"], jnp.arange(spec.num_layers)))

    x = ops.norm(x, params["final_scale"], params["final_bias"],
                 kind=spec.norm, eps=spec.norm_eps, impl=impl)
    # take the hidden state at each sequence's last true token
    last = jnp.clip(seq_lens - 1, 0, S - 1)
    x_last = jnp.take_along_axis(x, last[:, None, None].astype(jnp.int32)
                                 .repeat(x.shape[-1], -1), axis=1)[:, 0]
    return lm_logits(params, spec, x_last, impl), k_pool, v_pool


@functools.partial(jax.jit, static_argnames=("spec", "impl"),
                   donate_argnums=(3, 4))
def decode_paged(
    params,
    spec: ModelSpec,
    tokens: jax.Array,        # [B] current tokens
    k_pool: jax.Array,
    v_pool: jax.Array,
    block_tables: jax.Array,  # [B, max_blocks]
    context_lens: jax.Array,  # [B] length INCLUDING this token
    *,
    impl: Impl = Impl(),
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One decode step for all sequences → (logits [B, V], pools)."""
    B = tokens.shape[0]
    positions = context_lens - 1  # [B]
    x, (cos, sin) = _embed(params, spec, tokens[:, None], positions[:, None])
    # Inactive slots are handled by the engine: their table rows point at a
    # reserved scratch block (id 0) and ctx stays 1, so their writes land in
    # the scratch block and never corrupt live sequences.

    def block_fn(carry, inputs):
        x, k_pool, v_pool = carry
        bp, layer = inputs
        h = ops.norm(x, bp["ln1_scale"], bp["ln1_bias"], kind=spec.norm,
                     eps=spec.norm_eps, impl=impl)
        qf, kf, vf = _qkv_proj(h, bp, spec, impl)
        q = _split_heads(qf, spec.num_heads)
        k = _split_heads(kf, spec.num_kv_heads)
        v = _split_heads(vf, spec.num_kv_heads)
        if cos is not None:
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        k_pool, v_pool = reshape_and_cache(k_pool, v_pool, k, v,
                                           block_tables, positions, layer)
        attn = ops.paged_decode_attention(q[:, 0], k_pool, v_pool,
                                          block_tables, context_lens,
                                          layer=layer, impl=impl)
        attn_out = ops.linear(attn.reshape(B, 1, spec.q_dim).astype(x.dtype),
                              bp["wo"], bp["bo"], impl=impl)
        x = _residual_tail(x, attn_out, h, bp, spec, impl)
        return (x, k_pool, v_pool), None

    (x, k_pool, v_pool), _ = jax.lax.scan(
        block_fn, (x, k_pool, v_pool),
        (params["blocks"], jnp.arange(spec.num_layers)))

    x = ops.norm(x, params["final_scale"], params["final_bias"],
                 kind=spec.norm, eps=spec.norm_eps, impl=impl)[:, 0]
    return lm_logits(params, spec, x, impl), k_pool, v_pool
