"""Op dispatch layer: one call site per op, implementation chosen by Impl.

This replaces the reference's converter/registry indirection (FusionRegistry
inference.py:76, ModelConverter flash_attention.py:952, MLPConverter
fused_mlp.py:399): instead of swapping nn.Module objects at runtime, the
model calls these dispatchers and the Impl dataclass picks the code path at
trace time.

The backend is decided here and nowhere else:

  * ``Impl()`` (``attention="dense"``) is the plain path: the jnp references
    in :mod:`mlio_tpu.ops.reference`, compiled by XLA on any backend.
  * ``Impl(attention="flash")`` selects the GPU kernels: cuDNN fused
    attention for prefill and the Pallas-Triton paged decode kernel. They run
    compiled for the card. A kernel that cannot take its inputs raises; no
    call is handed to another path behind the caller's back.
  * ``Impl(interpret=True)`` runs the Pallas kernels in interpret mode (and
    the cuDNN call as XLA's implementation of the same call), which is how
    tests reach them on the CPU. Nothing turns it on implicitly.
"""
from __future__ import annotations

from mlio_tpu.ops.reference import (
    attention_reference,
    layernorm_reference,
    mlp_reference,
    rmsnorm_reference,
)
from mlio_tpu.ops.quant import QTensor, dequantize
from mlio_tpu.ops import quant as _quant


def interpret_mode(impl) -> bool:
    """Whether kernels run in Pallas interpret mode: only when asked."""
    return bool(impl is not None and impl.interpret)


def attention(q, k, v, *, causal=True, scale=None, q_offset=0, kv_len=None,
              mask=None, bias=None, k_scale=None, v_scale=None, impl=None,
              dropout_rate=0.0, dropout_seed=0, return_probs=False):
    """Multi-head attention dispatcher. q [B,Sq,Hq,D], k/v [B,Skv,Hkv,D].

    ``k_scale``/``v_scale`` [B,Skv,Hkv] mark an INT8-quantized KV cache;
    every path dequantizes it before attending. ``dropout_rate``/``dropout_seed``:
    position-hashed attention dropout (ops/dropmask.py). ``return_probs``
    routes through the dense reference and also returns the [B,Hq,Sq,Skv]
    softmax matrix (the reference's return_softmax debug surface — O(S^2)
    by nature).
    """
    kind = impl.attention if impl is not None else "dense"
    if kind in ("flash", "ring") and k_scale is not None and not return_probs:
        from mlio_tpu.ops.quant import dequantize_kv
        k = dequantize_kv(k, k_scale, q.dtype)
        v = dequantize_kv(v, v_scale, q.dtype)
        k_scale = v_scale = None
    if kind == "flash" and not return_probs:
        if mask is not None or bias is not None or dropout_rate > 0.0:
            raise NotImplementedError(
                "the flash path (cuDNN) takes no user mask, bias or "
                "dropout; use Impl() for those")
        from mlio_tpu.ops.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset, kv_len=kv_len,
                               interpret=interpret_mode(impl))
    if kind == "ring" and mask is None:
        from mlio_tpu.ops import ring_attention as ra
        if dropout_rate > 0.0:
            raise NotImplementedError(
                "attention dropout is not plumbed through the ring chunk "
                "schedule; use the dense path for dropout")
        return ra.chunked_ring_attention(
            q, k, v, causal=causal, scale=scale, q_offset=q_offset,
            kv_len=kv_len, chunk_size=impl.ring_chunk)
    return attention_reference(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset, kv_len=kv_len, mask=mask,
                               bias=bias, k_scale=k_scale, v_scale=v_scale,
                               dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed,
                               return_probs=return_probs)


def decode_attention(q, k_cache, v_cache, context_lens, *, layer,
                     k_scales=None, v_scales=None, impl=None):
    """One decode token per sequence over the contiguous cache
    [L, B, Smax, Hkv, D] → [B, Hq, D]. The flash path reads only the
    ``context_lens`` prefix of layer ``layer`` in place; the dense path
    slices the layer and masks the whole static cache."""
    if impl is not None and impl.attention == "flash":
        from mlio_tpu.ops.paged_attention import decode_attention as kernel
        return kernel(q, k_cache, v_cache, context_lens, layer=layer,
                      k_scales=k_scales, v_scales=v_scales,
                      interpret=interpret_mode(impl))
    B, Hq, D = q.shape
    ks = None if k_scales is None else k_scales[layer]
    vs = None if v_scales is None else v_scales[layer]
    out = attention_reference(q.reshape(B, 1, Hq, D), k_cache[layer],
                              v_cache[layer], causal=False,
                              kv_len=context_lens, k_scale=ks, v_scale=vs)
    return out[:, 0]


def paged_decode_attention(q, k_pool, v_pool, block_tables, context_lens, *, layer,
                    k_scale_pool=None, v_scale_pool=None, impl=None):
    """One decode token per sequence over the paged pools → [B, Hq, D]."""
    from mlio_tpu.ops import paged_attention as pa
    if impl is not None and impl.attention == "flash":
        return pa.paged_attention(q, k_pool, v_pool, block_tables,
                                  context_lens, layer=layer,
                                  k_scale_pool=k_scale_pool,
                                  v_scale_pool=v_scale_pool,
                                  interpret=interpret_mode(impl))
    return pa.paged_attention_reference(q, k_pool, v_pool, block_tables,
                                        context_lens, layer=layer,
                                        k_scale_pool=k_scale_pool,
                                        v_scale_pool=v_scale_pool)


def linear(x, w, bias=None, *, impl=None):
    """x @ w (+bias); w may be a QTensor (dequantized into the GEMM)."""
    return _quant.linear(x, w, bias)


def activate(h, gate, activation):
    """MLP activation in f32: ``act(gate) * h`` for gated kinds, else
    ``act(h)``."""
    import jax
    import jax.numpy as jnp

    hf = h.astype(jnp.float32)
    if activation == "swiglu":
        return jax.nn.silu(gate.astype(jnp.float32)) * hf
    if activation == "geglu":
        return jax.nn.gelu(gate.astype(jnp.float32), approximate=True) * hf
    if activation in ("gelu_new", "gelu_tanh"):
        return jax.nn.gelu(hf, approximate=True)
    if activation == "gelu":
        return jax.nn.gelu(hf, approximate=False)
    if activation == "relu":
        return jnp.maximum(hf, 0.0)
    raise ValueError(f"unknown activation {activation}")


def mlp(x, w_up, w_down, *, b_up=None, b_down=None, w_gate=None, b_gate=None,
        activation="gelu_new", impl=None):
    """MLP dispatcher (dense or quantized weights)."""
    if isinstance(w_up, QTensor):
        h = _quant.linear(x, w_up, b_up)
        g = (_quant.linear(x, w_gate, b_gate)
             if activation in ("swiglu", "geglu") else None)
        h = activate(h, g, activation).astype(x.dtype)
        return _quant.linear(h, w_down, b_down)
    return mlp_reference(x, w_up, w_down, b_up=b_up, b_down=b_down,
                         w_gate=w_gate, b_gate=b_gate, activation=activation)


def norm(x, scale, bias=None, *, kind="layernorm", eps=1e-5, residual=None,
         impl=None):
    """Norm dispatcher: LayerNorm or RMSNorm (XLA fuses the reductions)."""
    if kind == "rmsnorm":
        return rmsnorm_reference(x, scale, eps=eps, residual=residual)
    return layernorm_reference(x, scale, bias, eps=eps, residual=residual)


def moe_mlp(x, w_router, w_gate, w_up, w_down, *, top_k,
            activation="swiglu", method="ragged", capacity_factor=2.0):
    """Mixture-of-Experts MLP dispatcher (see ops/moe.py; capability
    addition — the reference has no MoE, SURVEY.md §2.5)."""
    from mlio_tpu.ops import moe as _moe
    return _moe.moe_mlp(x, w_router, w_gate, w_up, w_down, top_k=top_k,
                        activation=activation, method=method,
                        capacity_factor=capacity_factor)


__all__ = [
    "attention",
    "activate",
    "decode_attention",
    "interpret_mode",
    "linear",
    "mlp",
    "moe_mlp",
    "norm",
    "paged_decode_attention",
    "QTensor",
    "dequantize",
    "attention_reference",
    "mlp_reference",
    "layernorm_reference",
    "rmsnorm_reference",
]
