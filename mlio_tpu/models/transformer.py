"""Functional decoder-only transformer (GPT-2 / Llama families).

Replaces the reference's load-and-monkeypatch runtime
(/root/reference/baseline/inference.py, model_loader.py): here the model is a
pure function over a parameter pytree. Layers are stacked on a leading axis
and iterated with ``jax.lax.scan`` so compile time is O(1) in depth and XLA
sees one fused layer body. Kernel choices (cuDNN attention, the paged
decode kernel) are selected by the :class:`Impl` dataclass at trace
time — the equivalent of the reference's ModelConverter / FusionRegistry
module surgery (inference.py:76-375).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from mlio_tpu.models.spec import ModelSpec
from mlio_tpu import ops

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Impl:
    """Compile-time implementation choices (replaces runtime converters).

    Reference counterparts: FlashAttentionConfig flash_attention.py:53-104,
    FusionRegistry inference.py:76. See :mod:`mlio_tpu.ops` for what each
    choice runs.
    """

    attention: str = "dense"  # "dense" | "flash" | "ring"
    ring_chunk: int = 512
    interpret: bool = False  # Pallas interpret mode (tests on the CPU)
    # MoE execution method: "ragged" (dropless grouped matmul, single-shard
    # default), "dispatch" (GShard einsum dispatch — the expert-parallel
    # path), "dense" (all-experts oracle). See ops/moe.py.
    moe: str = "ragged"
    moe_capacity_factor: float = 2.0


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------

def init_params(spec: ModelSpec, key: jax.Array, dtype=jnp.float32) -> Params:
    """Random-init a parameter pytree with the stacked-layer layout.

    Layout: every per-layer weight has a leading ``num_layers`` axis; matmul
    weights are stored [in, out] (row-major for x @ W).
    """
    spec.validate()
    h, i, l = spec.hidden_size, spec.intermediate_size, spec.num_layers
    qd, kvd = spec.q_dim, spec.kv_dim
    keys = jax.random.split(key, 8)

    def w(k, shape, fan_in):
        return (jax.random.normal(k, shape) * (fan_in ** -0.5)).astype(dtype)

    def maybe_zeros(shape, cond):
        return jnp.zeros(shape, dtype) if cond else None

    blocks = {
        "ln1_scale": jnp.ones((l, h), dtype),
        "ln1_bias": maybe_zeros((l, h), spec.norm == "layernorm"),
        "wq": w(keys[0], (l, h, qd), h),
        "bq": maybe_zeros((l, qd), spec.use_qkv_bias),
        "wk": w(keys[1], (l, h, kvd), h),
        "bk": maybe_zeros((l, kvd), spec.use_qkv_bias),
        "wv": w(keys[2], (l, h, kvd), h),
        "bv": maybe_zeros((l, kvd), spec.use_qkv_bias),
        "wo": w(keys[3], (l, qd, h), qd),
        "bo": maybe_zeros((l, h), spec.use_out_bias),
        "ln2_scale": jnp.ones((l, h), dtype),
        "ln2_bias": maybe_zeros((l, h), spec.norm == "layernorm"),
        "w_up": w(keys[4], (l, h, i), h),
        "b_up": maybe_zeros((l, i), spec.use_mlp_bias),
        "w_gate": (w(keys[5], (l, h, i), h)
                   if spec.activation in ("swiglu", "geglu") else None),
        "b_gate": maybe_zeros(
            (l, i),
            spec.use_mlp_bias and spec.activation in ("swiglu", "geglu")),
        "w_down": w(keys[6], (l, i, h), i),
        "b_down": maybe_zeros((l, h), spec.use_mlp_bias),
    }
    if spec.num_experts:  # sparse MoE: expert-stacked MLP + router
        E = spec.num_experts
        gated = spec.activation in ("swiglu", "geglu")
        blocks.update({
            "w_up": None, "b_up": None, "w_gate": None, "b_gate": None,
            "w_down": None, "b_down": None,
            "router": w(keys[4], (l, h, E), h),
            "moe_up": w(keys[5], (l, E, h, i), h),
            "moe_gate": w(keys[6], (l, E, h, i), h) if gated else None,
            "moe_down": w(keys[6], (l, E, i, h), i),
        })
    params: Params = {
        "tok_embed": (jax.random.normal(keys[7], (spec.vocab_size, h)) * 0.02).astype(dtype),
        "pos_embed": (
            (jax.random.normal(keys[7], (spec.max_seq_len, h)) * 0.01).astype(dtype)
            if spec.positional == "learned" else None
        ),
        "blocks": blocks,
        "final_scale": jnp.ones((h,), dtype),
        "final_bias": maybe_zeros((h,), spec.norm == "layernorm"),
        "lm_head": None if spec.tie_embeddings else w(keys[7], (h, spec.vocab_size), h),
        "lm_head_bias": (jnp.zeros((spec.vocab_size,), dtype)
                         if spec.use_head_bias else None),
    }
    return params


# ---------------------------------------------------------------------------
# RoPE (HF Llama convention: half-split rotate, not interleaved)
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: jax.Array, head_dim: int, theta: float,
                 dtype=jnp.float32) -> Tuple[jax.Array, jax.Array]:
    """cos/sin tables for given positions ([...,] -> [..., head_dim])."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (jnp.arange(0, half, dtype=jnp.float32) / half))
    freqs = positions.astype(jnp.float32)[..., None] * inv_freq  # [..., half]
    emb = jnp.concatenate([freqs, freqs], axis=-1)
    return jnp.cos(emb).astype(dtype), jnp.sin(emb).astype(dtype)


def apply_rope(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """x: [B, S, H, D]; cos/sin: [B, S, R] or [S, R] with R <= D.

    R < D is partial rotary (GPT-NeoX rotary_pct / Phi
    partial_rotary_factor): only the first R dims rotate, the tail passes
    through."""
    if cos.ndim == 2:
        cos = cos[None]
        sin = sin[None]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    rot_dim = cos.shape[-1]
    xr = x[..., :rot_dim]
    half = rot_dim // 2
    x1, x2 = xr[..., :half], xr[..., half:]
    rotated = jnp.concatenate([-x2, x1], axis=-1)
    out = (xr * cos + rotated * sin).astype(x.dtype)
    if rot_dim == x.shape[-1]:
        return out
    return jnp.concatenate([out, x[..., rot_dim:]], axis=-1)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _split_heads(x: jax.Array, num_heads: int) -> jax.Array:
    B, S, _ = x.shape
    return x.reshape(B, S, num_heads, -1)


def _qkv_proj(h_norm, bp, spec, impl):
    """Project to (q, k, v), flat [B, S, *_dim]: one fused ``wqkv`` weight
    (one matmul + splits, see runtime.quantization.fuse_projections) or
    separate wq/wk/wv."""
    if bp.get("wqkv") is not None:
        y = ops.linear(h_norm, bp["wqkv"], bp.get("bqkv"), impl=impl)
        qd, kvd = spec.q_dim, spec.kv_dim
        return y[..., :qd], y[..., qd:qd + kvd], y[..., qd + kvd:]
    q = ops.linear(h_norm, bp["wq"], bp["bq"], impl=impl)
    k = ops.linear(h_norm, bp["wk"], bp["bk"], impl=impl)
    v = ops.linear(h_norm, bp["wv"], bp["bv"], impl=impl)
    return q, k, v


def _run_mlp(h, bp, spec, impl):
    """MLP sublayer; supports the fused [up | gate] projection layout
    (runtime.quantization.fuse_projections) and sparse MoE routing."""
    if bp.get("router") is not None:
        return ops.moe_mlp(
            h, bp["router"], bp.get("moe_gate"), bp["moe_up"],
            bp["moe_down"], top_k=spec.num_experts_per_tok,
            activation=spec.activation, method=impl.moe,
            capacity_factor=impl.moe_capacity_factor).astype(h.dtype)
    if bp.get("w_upgate") is not None:
        y = ops.linear(h, bp["w_upgate"], bp.get("b_upgate"), impl=impl)
        i = spec.intermediate_size
        if y.shape[-1] == 2 * i:  # gated: [up | gate] halves
            act = ops.activate(y[..., :i], y[..., i:], spec.activation)
        else:
            act = ops.activate(y, None, spec.activation)
        return ops.linear(act.astype(h.dtype), bp["w_down"],
                          bp["b_down"], impl=impl)
    return ops.mlp(h, bp["w_up"], bp["w_down"],
                   b_up=bp["b_up"], b_down=bp["b_down"],
                   w_gate=bp["w_gate"], b_gate=bp["b_gate"],
                   activation=spec.activation, impl=impl)


def _residual_tail(x, attn_out, h_norm1, bp, spec, impl):
    """Residual combination: sequential (GPT-2/Llama) or parallel
    (GPT-NeoX: x + attn(ln1 x) + mlp(ln2 x); Phi shares one LN for both)."""
    def run_mlp(h):
        return _run_mlp(h, bp, spec, impl)

    if spec.parallel_residual:
        h2 = h_norm1 if spec.shared_ln else ops.norm(
            x, bp["ln2_scale"], bp["ln2_bias"], kind=spec.norm,
            eps=spec.norm_eps, impl=impl)
        return x + attn_out + run_mlp(h2)
    x = x + attn_out
    h2 = ops.norm(x, bp["ln2_scale"], bp["ln2_bias"], kind=spec.norm,
                  eps=spec.norm_eps, impl=impl)
    return x + run_mlp(h2)


def run_layer_stack(x: jax.Array, blocks, spec: ModelSpec, impl: Impl,
                    cos=None, sin=None, weight_dtype=None) -> jax.Array:
    """Run a stack of transformer blocks (no KV cache) over x [B, S, H].

    Shared by the cache-free path consumers and the pipeline orchestrator,
    which shards the stacked-layer axis across the "pipe" mesh axis and
    calls this per stage. ``weight_dtype`` casts each layer's weights inside
    the scan (a float32 reference over bf16 weights without a float32 copy
    of the whole model).
    """
    B, S, _ = x.shape

    def block_fn(x, bp):
        if weight_dtype is not None:
            bp = jax.tree_util.tree_map(lambda w: w.astype(weight_dtype), bp)
        h_norm = ops.norm(x, bp["ln1_scale"], bp["ln1_bias"], kind=spec.norm,
                          eps=spec.norm_eps, impl=impl)
        q, k, v = _qkv_proj(h_norm, bp, spec, impl)
        q = _split_heads(q, spec.num_heads)
        k = _split_heads(k, spec.num_kv_heads)
        v = _split_heads(v, spec.num_kv_heads)
        if cos is not None:
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        attn = ops.attention(q, k, v, causal=True, impl=impl)
        attn = attn.reshape(B, S, spec.q_dim)
        attn_out = ops.linear(attn, bp["wo"], bp["bo"], impl=impl)
        return _residual_tail(x, attn_out, h_norm, bp, spec, impl), None

    x, _ = jax.lax.scan(block_fn, x, blocks)
    return x


def forward(
    params: Params,
    spec: ModelSpec,
    input_ids: jax.Array,
    *,
    impl: Impl = Impl(),
    cache: Optional[Dict[str, jax.Array]] = None,
    positions: Optional[jax.Array] = None,
    return_hidden: bool = False,
) -> Tuple[jax.Array, Optional[Dict[str, jax.Array]]]:
    """Run the model on ``input_ids`` [B, S].

    Without a cache this is a full (prefill/scoring) forward. With a cache
    (see :mod:`mlio_tpu.runtime.kv_cache`) the S new tokens are written at
    ``cache['pos']`` and attention runs over the cached context with a
    static-shape KV-length mask — the static-shapes design rule that replaces
    the reference's dynamic Python block lists (inference.py:791-1302).

    Returns (logits [B, S, V], updated cache or None).
    """
    B, S = input_ids.shape
    x = params["tok_embed"][input_ids]  # [B, S, H]
    if spec.embed_scale is not None:  # Gemma scales embeddings by sqrt(h)
        x = x * jnp.asarray(spec.embed_scale, x.dtype)

    cache_pos = cache["pos"] if cache is not None else jnp.int32(0)
    if positions is None:
        positions = jnp.arange(S, dtype=jnp.int32)[None, :] + cache_pos  # [1|B, S]
        positions = jnp.broadcast_to(positions, (B, S))

    if spec.positional == "learned":
        x = x + params["pos_embed"][positions].astype(x.dtype)
        cos = sin = None
    else:
        cos, sin = rope_cos_sin(positions, spec.rope_dim, spec.rope_theta,
                                jnp.float32)

    if cache is None:
        x = run_layer_stack(x, params["blocks"], spec, impl, cos, sin)
        new_cache = None
    else:
        x, new_cache = _cached_layer_stack(x, params["blocks"], cache, spec,
                                           impl, cos, sin)
    x = ops.norm(x, params["final_scale"], params["final_bias"], kind=spec.norm,
                 eps=spec.norm_eps, impl=impl)
    if return_hidden:
        return x, new_cache
    return lm_logits(params, spec, x, impl), new_cache


def lm_logits(params: Params, spec: ModelSpec, x: jax.Array,
              impl: Impl = Impl()) -> jax.Array:
    """Final-norm hidden states → logits (untied or tied head, softcap)."""
    if params["lm_head"] is not None:
        logits = ops.linear(x, params["lm_head"], params.get("lm_head_bias"),
                            impl=impl)
    else:
        logits = x @ params["tok_embed"].T.astype(x.dtype)
    if spec.logits_softcap is not None:
        cap = spec.logits_softcap
        logits = cap * jnp.tanh(logits / cap)
    return logits


def _cached_layer_stack(x, blocks, cache, spec, impl, cos, sin):
    """Layer scan over the contiguous cache [L, B, Smax, Hkv, D].

    The whole cache rides the scan CARRY, so XLA updates it in place: one
    dynamic-update-slice of the S new tokens per layer, no per-step copy of
    the cache through the scan's outputs. A single decode token (S == 1)
    attends through ``ops.decode_attention``; longer chunks through
    ``ops.attention`` over the layer's cache with ``q_offset`` = position.
    """
    B, S, _ = x.shape
    dtype = x.dtype
    pos = cache["pos"]
    kv_len = pos + S
    quant = "k_scale" in cache

    def block_fn(carry, inputs):
        x, ck, cv, cks, cvs = carry
        bp, layer = inputs
        h_norm = ops.norm(x, bp["ln1_scale"], bp["ln1_bias"], kind=spec.norm,
                          eps=spec.norm_eps, impl=impl)
        q, k, v = _qkv_proj(h_norm, bp, spec, impl)
        q = _split_heads(q, spec.num_heads)
        k = _split_heads(k, spec.num_kv_heads)
        v = _split_heads(v, spec.num_kv_heads)
        if cos is not None:
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        if quant:
            from mlio_tpu.ops.quant import quantize_kv

            k, ksc = quantize_kv(k)
            v, vsc = quantize_kv(v)
            cks = jax.lax.dynamic_update_slice(cks, ksc[None],
                                               (layer, 0, pos, 0))
            cvs = jax.lax.dynamic_update_slice(cvs, vsc[None],
                                               (layer, 0, pos, 0))
        ck = jax.lax.dynamic_update_slice(ck, k.astype(ck.dtype)[None],
                                          (layer, 0, pos, 0, 0))
        cv = jax.lax.dynamic_update_slice(cv, v.astype(cv.dtype)[None],
                                          (layer, 0, pos, 0, 0))
        if S == 1:
            attn = ops.decode_attention(
                q[:, 0], ck, cv, jnp.full((B,), kv_len, jnp.int32),
                layer=layer, k_scales=cks if quant else None,
                v_scales=cvs if quant else None, impl=impl)
        else:
            lk, lv = ck[layer], cv[layer]
            if not quant:
                lk, lv = lk.astype(dtype), lv.astype(dtype)
            attn = ops.attention(q, lk, lv, causal=True, q_offset=pos,
                                 kv_len=kv_len,
                                 k_scale=cks[layer] if quant else None,
                                 v_scale=cvs[layer] if quant else None,
                                 impl=impl)
        attn = attn.reshape(B, S, spec.q_dim).astype(dtype)
        attn_out = ops.linear(attn, bp["wo"], bp["bo"], impl=impl)
        x = _residual_tail(x, attn_out, h_norm, bp, spec, impl)
        return (x, ck, cv, cks, cvs), None

    none = jnp.zeros((), dtype)
    carry0 = (x, cache["k"], cache["v"], cache.get("k_scale", none),
              cache.get("v_scale", none))
    (x, ck, cv, cks, cvs), _ = jax.lax.scan(
        block_fn, carry0, (blocks, jnp.arange(spec.num_layers)))
    new_cache = {"k": ck, "v": cv, "pos": pos + S}
    if quant:
        new_cache["k_scale"] = cks
        new_cache["v_scale"] = cvs
    return x, new_cache
