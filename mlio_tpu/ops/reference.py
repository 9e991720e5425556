"""Pure-jnp reference implementations of every optimized op.

These are the trusted-dense baselines each kernel is validated against,
mirroring the reference's pattern of shipping a PyTorch fallback next to
every Triton kernel (e.g. pytorch_flash_attention
/root/reference/kernels/triton/flash_attention_kernels.py:1569,
pytorch_fused_mlp mlp_kernels.py:759, pytorch_layernorm
layernorm_kernels.py:279). They are also the plain path that ``Impl()``
runs on every backend, compiled by XLA.

Shapes (head dim last):
  q: [B, Sq, Hq, D]   k, v: [B, Skv, Hkv, D]   Hkv divides Hq (GQA/MQA).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def canonicalize_mask(mask: jax.Array, B: int, Hq: int, Sq: int, Skv: int):
    """Canonicalize a user attention mask (nonzero = attend).

    Mirrors the reference's shape rules
    (flash_attention_kernels.py:1232-1271):
      [B, Skv]            key/padding mask (left- or right-padding)
      [B, 1, Skv]         same
      [B, Sq, Skv]        per-query mask
      [B, Hq|1, Sq, Skv]  full per-head mask
    Returns ("key", [B, Skv] int8) or ("full", [B, Hm, Sq, Skv] int8).
    """
    m = jnp.asarray(mask)
    if m.ndim == 2:
        if m.shape != (B, Skv):
            raise ValueError(f"2D mask must be [batch, kv_len]; got "
                             f"{m.shape} for B={B}, Skv={Skv}")
        return "key", m.astype(jnp.int8)
    if m.ndim == 3:
        if m.shape[1] == 1 and m.shape == (B, 1, Skv):
            return "key", m[:, 0].astype(jnp.int8)
        if m.shape != (B, Sq, Skv):
            raise ValueError(f"3D mask must be [B, Sq, Skv]; got {m.shape}")
        return "full", m[:, None].astype(jnp.int8)
    if m.ndim == 4:
        if m.shape[0] != B or m.shape[1] not in (1, Hq) \
                or m.shape[2:] != (Sq, Skv):
            raise ValueError(f"4D mask must be [B, 1|Hq, Sq, Skv]; got "
                             f"{m.shape}")
        return "full", m.astype(jnp.int8)
    raise ValueError(f"unsupported mask rank {m.ndim}")


def attention_reference(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset=0,
    kv_len=None,
    mask: Optional[jax.Array] = None,
    bias: Optional[jax.Array] = None,
    k_scale: Optional[jax.Array] = None,
    v_scale: Optional[jax.Array] = None,
    dropout_rate: float = 0.0,
    dropout_seed=0,
    return_probs: bool = False,
) -> jax.Array:
    """Dense softmax attention with GQA, causal masking and KV-length masking.

    ``mask`` (nonzero = attend) accepts the shapes of
    :func:`canonicalize_mask`: [B,Skv], [B,1,Skv], [B,Sq,Skv],
    [B,1|Hq,Sq,Skv].

    ``q_offset`` is the absolute position of q[:, 0] (for decode steps where
    the query sits at the end of the cached context). ``kv_len`` masks cache
    slots >= kv_len (scalar or [B]). Computation in fp32, output in q.dtype.
    Parity: the reference's blockwise fallback flash_attention.py:277-407.
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if scale is None:
        scale = D ** -0.5
    group = Hq // Hkv

    if k_scale is not None:
        # INT8 KV cache: dequantize densely (the kernels fuse this instead)
        k = k.astype(jnp.float32) * k_scale.astype(jnp.float32)[..., None]
        v = v.astype(jnp.float32) * v_scale.astype(jnp.float32)[..., None]

    qf = q.astype(jnp.float32)
    kf = k.astype(jnp.float32)
    vf = v.astype(jnp.float32)
    if group > 1:
        kf = jnp.repeat(kf, group, axis=2)
        vf = jnp.repeat(vf, group, axis=2)

    # [B, H, Sq, Skv]
    scores = jnp.einsum("bqhd,bkhd->bhqk", qf, kf) * scale

    user_mask = mask
    mask = None
    if causal:
        q_pos = jnp.arange(Sq)[:, None] + q_offset
        k_pos = jnp.arange(Skv)[None, :]
        mask = q_pos >= k_pos  # [Sq, Skv]
        mask = mask[None, None, :, :]
    if kv_len is not None:
        kv_len = jnp.asarray(kv_len)
        if kv_len.ndim == 0:
            valid = jnp.arange(Skv)[None, :] < kv_len
            valid = valid[None, None, :, :]
        else:
            valid = jnp.arange(Skv)[None, :] < kv_len[:, None]
            valid = valid[:, None, None, :]
        mask = valid if mask is None else jnp.logical_and(mask, valid)
    if user_mask is not None:
        kind, m = canonicalize_mask(user_mask, B, Hq, Sq, Skv)
        um = (m[:, None, None, :] if kind == "key" else m) != 0
        mask = um if mask is None else jnp.logical_and(mask, um)
    if mask is not None:
        scores = jnp.where(mask, scores, -jnp.inf)
    if bias is not None:
        scores = scores + bias.astype(jnp.float32)

    probs = jax.nn.softmax(scores, axis=-1)
    # Rows that are fully masked produce NaN from softmax(-inf); zero them.
    probs = jnp.where(jnp.isnan(probs), 0.0, probs)
    pv_probs = probs
    if dropout_rate > 0.0:
        # post-softmax dropout from a position-hashed mask
        # (ops/dropmask.py): the same (seed, position) always drops the
        # same element, on every backend. Parity: reference
        # FlashAttentionConfig.dropout (flash_attention.py:53-104).
        from mlio_tpu.ops.dropmask import dense_keep_mask

        keep = dense_keep_mask(B, Hq, Sq, Skv, dropout_seed, dropout_rate,
                               q_offset=q_offset)
        pv_probs = jnp.where(keep, probs, 0.0) / (1.0 - dropout_rate)
    out = jnp.einsum("bhqk,bkhd->bqhd", pv_probs, vf)
    if return_probs:
        # parity: the reference's return_softmax debug surface
        # (flash_attention.py:53-104) — O(Sq*Skv) by nature
        return out.astype(q.dtype), probs
    return out.astype(q.dtype)


def mlp_reference(
    x: jax.Array,
    w_up: jax.Array,
    w_down: jax.Array,
    *,
    b_up: Optional[jax.Array] = None,
    b_down: Optional[jax.Array] = None,
    w_gate: Optional[jax.Array] = None,
    b_gate: Optional[jax.Array] = None,
    activation: str = "gelu_new",
) -> jax.Array:
    """Dense MLP: up-proj → activation (→ gate for SwiGLU) → down-proj.

    Parity: pytorch_fused_mlp mlp_kernels.py:759 and the FusedMLP family
    fused_mlp.py:28-397 (GeluTanh / ReLU / SwiGLU variants).
    """
    h = x @ w_up
    if b_up is not None:
        h = h + b_up
    if activation in ("swiglu", "geglu"):
        assert w_gate is not None
        g = x @ w_gate
        if b_gate is not None:
            g = g + b_gate
        gated = (jax.nn.silu(g) if activation == "swiglu"
                 else jax.nn.gelu(g, approximate=True))
        h = gated * h
    elif activation in ("gelu_new", "gelu_tanh"):
        h = jax.nn.gelu(h, approximate=True)
    elif activation == "gelu":
        h = jax.nn.gelu(h, approximate=False)
    elif activation == "relu":
        h = jax.nn.relu(h)
    else:
        raise ValueError(f"unknown activation {activation}")
    out = h @ w_down
    if b_down is not None:
        out = out + b_down
    return out


def layernorm_reference(
    x: jax.Array,
    scale: jax.Array,
    bias: Optional[jax.Array] = None,
    *,
    eps: float = 1e-5,
    residual: Optional[jax.Array] = None,
    residual_alpha: float = 1.0,
) -> jax.Array:
    """LayerNorm with optional fused residual ``LN(x + alpha * residual)``.

    Parity: pytorch_layernorm layernorm_kernels.py:279 and the fused
    residual variant layernorm_kernels.py:112-184. Stats in fp32.
    """
    if residual is not None:
        x = x + residual_alpha * residual
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + eps)
    y = y * scale.astype(jnp.float32)
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    return y.astype(x.dtype)


def rmsnorm_reference(
    x: jax.Array,
    scale: jax.Array,
    *,
    eps: float = 1e-5,
    residual: Optional[jax.Array] = None,
) -> jax.Array:
    """RMSNorm (Llama-family norm), fp32 stats, optional fused residual."""
    if residual is not None:
        x = x + residual
    xf = x.astype(jnp.float32)
    ms = jnp.mean(jnp.square(xf), axis=-1, keepdims=True)
    y = xf * jax.lax.rsqrt(ms + eps)
    return (y * scale.astype(jnp.float32)).astype(x.dtype)
