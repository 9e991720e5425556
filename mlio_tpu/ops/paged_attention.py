"""Paged KV cache: pools, reshape-and-cache, and decode attention.

Rebuild of the reference's paged Triton kernels
(/root/reference/kernels/triton/attention_kernels.py:
_paged_attention_fwd_kernel :628-808, _reshape_and_cache_kernel :811-905,
wrappers :1206-1410) — decode attention over a non-contiguous KV cache
addressed through per-sequence block tables.

Pool layout is [L, num_blocks, block_size, H_kv, D] for every layer at once.
Decode attention has two paths:

  * :func:`paged_attention_reference` gathers each sequence's blocks with
    XLA and runs dense masked attention. It runs on any backend.
  * :func:`paged_attention` is a Pallas kernel for the Triton route. It takes
    the WHOLE pool plus the layer index, so a call inside the layer scan
    reads only the live blocks of that layer in place: no per-layer slice of
    the pool and no gathered copy of the context. The grid is
    (batch, kv head, context split); each program loops over its share of
    the sequence's blocks with an online softmax and writes unnormalised
    partial results that a small XLA epilogue merges (split-K, so a batch of
    8 sequences still fills the card's SMs).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# finite "minus infinity": exp(_NEG - _NEG) stays defined for rows whose
# split holds no valid key
_NEG = -1e30


def init_kv_pools(num_layers: int, num_blocks: int, num_kv_heads: int,
                  block_size: int, head_dim: int, dtype=jnp.bfloat16,
                  quant: Optional[str] = None):
    """Allocate K/V pools [L, NB, bs, Hkv, D].

    ``quant="int8"`` returns (k, v, k_scale, v_scale) with int8 pools and
    per-(slot, head) fp32 scale pools [L, NB, bs, Hkv]."""
    shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
    if quant == "int8":
        sshape = shape[:-1]
        return (jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8),
                jnp.ones(sshape, jnp.float32), jnp.ones(sshape, jnp.float32))
    return jnp.zeros(shape, dtype), jnp.zeros(shape, dtype)


def _scatter_scales(pool: jax.Array, scales: jax.Array, flat_idx: jax.Array,
                    B: int, S_new: int, Hkv: int) -> jax.Array:
    """Scatter [B, S_new, Hkv] scales into a [L, NB, bs, Hkv] pool."""
    dnums = lax.ScatterDimensionNumbers(
        update_window_dims=(1,),
        inserted_window_dims=(0, 1, 2),
        scatter_dims_to_operand_dims=(0, 1, 2),
    )
    upd = scales.reshape(B * S_new, Hkv)
    return lax.scatter(pool, flat_idx, upd.astype(pool.dtype), dnums,
                       indices_are_sorted=False, unique_indices=True,
                       mode=lax.GatherScatterMode.PROMISE_IN_BOUNDS)


def reshape_and_cache_quant(
    k_pool, v_pool, ks_pool, vs_pool,
    k_new, v_new, block_tables, write_pos, layer,
):
    """INT8 variant: quantize per (token, head), write values + scales."""
    from mlio_tpu.ops.quant import quantize_kv

    B, S_new, Hkv, D = k_new.shape
    bs = k_pool.shape[2]
    kq, ksc = quantize_kv(k_new)
    vq, vsc = quantize_kv(v_new)
    k_pool, v_pool = reshape_and_cache(k_pool, v_pool, kq, vq, block_tables,
                                       write_pos, layer)
    pos = write_pos[:, None] + jnp.arange(S_new)[None, :]
    logical = pos // bs
    offset = pos % bs
    physical = jnp.take_along_axis(block_tables, logical, axis=1)
    flat_idx = jnp.stack([
        jnp.broadcast_to(jnp.asarray(layer, jnp.int32), (B, S_new)),
        physical, offset], axis=-1).reshape(-1, 3)
    ks_pool = _scatter_scales(ks_pool, ksc, flat_idx, B, S_new, Hkv)
    vs_pool = _scatter_scales(vs_pool, vsc, flat_idx, B, S_new, Hkv)
    return k_pool, v_pool, ks_pool, vs_pool


# ---------------------------------------------------------------------------
# reshape_and_cache: scatter new tokens' K/V into the pools
# ---------------------------------------------------------------------------

def reshape_and_cache(
    k_pool: jax.Array,      # [L, NB, bs, Hkv, D]
    v_pool: jax.Array,
    k_new: jax.Array,       # [B, S_new, Hkv, D]
    v_new: jax.Array,
    block_tables: jax.Array,  # [B, max_blocks] int32
    write_pos: jax.Array,     # [B] int32: absolute position of k_new[:, 0]
    layer,
) -> Tuple[jax.Array, jax.Array]:
    """Write S_new tokens per sequence into the paged pools.

    Functional scatter; jit callers should donate the pools so XLA updates
    in place. The Triton reference writes one decode token (q_seq_len==1
    assumed, attention_kernels.py:1363-1365) — this generalizes to chunked
    prefill writes.
    """
    B, S_new, Hkv, D = k_new.shape
    bs = k_pool.shape[2]
    pos = write_pos[:, None] + jnp.arange(S_new)[None, :]  # [B, S_new]
    logical = pos // bs
    offset = pos % bs
    physical = jnp.take_along_axis(block_tables, logical, axis=1)  # [B, S_new]

    flat_idx = jnp.stack([
        jnp.broadcast_to(jnp.asarray(layer, jnp.int32), (B, S_new)),
        physical,
        offset,
    ], axis=-1).reshape(-1, 3)  # indexes dims (L, NB, bs)

    upd_k = k_new.reshape(B * S_new, Hkv, D)
    upd_v = v_new.reshape(B * S_new, Hkv, D)

    dnums = lax.ScatterDimensionNumbers(
        update_window_dims=(1, 2),            # (Hkv, D) of each update row
        inserted_window_dims=(0, 1, 2),       # L, NB, bs are indexed away
        scatter_dims_to_operand_dims=(0, 1, 2),
    )
    k_pool = lax.scatter(k_pool, flat_idx, upd_k.astype(k_pool.dtype), dnums,
                         indices_are_sorted=False, unique_indices=True,
                         mode=lax.GatherScatterMode.PROMISE_IN_BOUNDS)
    v_pool = lax.scatter(v_pool, flat_idx, upd_v.astype(v_pool.dtype), dnums,
                         indices_are_sorted=False, unique_indices=True,
                         mode=lax.GatherScatterMode.PROMISE_IN_BOUNDS)
    return k_pool, v_pool


# ---------------------------------------------------------------------------
# Paged decode attention: Pallas kernel (Triton route)
# ---------------------------------------------------------------------------

def decode_launch(batch: int, num_kv_heads: int, max_blocks: int,
                  block_size: int, num_sms: int = 132) -> Tuple[int, int, int]:
    """(pages_per_block, num_splits, pages_per_split) for a decode call.

    A loop iteration loads ``pages_per_block`` pages, i.e. 64-128 keys
    (Triton block dims are powers of two and the tensor-core dot needs at
    least 16). The context is split so the grid has about two programs per
    SM, but never into splits shorter than one loop iteration.
    """
    ppb = max(1, 64 // block_size)
    iters = -(-max_blocks // ppb)
    want = max(1, -(-2 * num_sms // (batch * num_kv_heads)))
    splits = max(1, min(want, iters))
    per_split = -(-iters // splits) * ppb
    splits = -(-max_blocks // per_split)
    return ppb, splits, per_split


def _decode_kernel(tables_ref, lens_ref, layer_ref, q_ref, k_ref, v_ref,
                   *refs, page_size, pages_per_block, pages_per_split,
                   num_blocks, scale, quant):
    if quant:
        ks_ref, vs_ref, o_ref, l_ref, m_ref = refs
    else:
        o_ref, l_ref, m_ref = refs
    b = pl.program_id(0)
    h = pl.program_id(1)
    split = pl.program_id(2)
    block_k = pages_per_block * page_size

    length = lens_ref[b]
    base = layer_ref[0] * num_blocks
    first = split * pages_per_split
    last = jnp.minimum(pl.cdiv(length, page_size), first + pages_per_split)
    q = q_ref[...]                                        # [Gp, D]
    gp, d = q.shape
    exact = dict(allow_tf32=False) if q.dtype == jnp.float32 else {}

    def body(i, carry):
        o, m, l = carry
        p0 = first + i * pages_per_block
        slot = p0 + jnp.arange(pages_per_block)
        # table entries past the context may be stale: read page 0 there
        pages = jnp.where(slot < last, tables_ref[b, pl.ds(p0, pages_per_block)],
                          0) + base
        k = k_ref[pages, :, h, :].reshape(block_k, d)
        v = v_ref[pages, :, h, :].reshape(block_k, d)
        s = pl.dot(q, k.astype(q.dtype), trans_b=True, **exact) * scale
        if quant:
            s = s * ks_ref[pages, :, h].reshape(1, block_k)
        pos = p0 * page_size + jnp.arange(block_k)
        s = jnp.where((pos < length)[None, :], s, _NEG)
        m_new = jnp.maximum(m, s.max(axis=-1))
        corr = jnp.exp(m - m_new)
        p = jnp.exp(s - m_new[:, None])
        l = l * corr + p.sum(axis=-1)
        if quant:
            p = p * vs_ref[pages, :, h].reshape(1, block_k)
        o = o * corr[:, None] + pl.dot(p.astype(q.dtype), v.astype(q.dtype),
                                       **exact)
        return o, m_new, l

    n_iter = pl.cdiv(jnp.maximum(last - first, 0), pages_per_block)
    o, m, l = lax.fori_loop(
        0, n_iter, body,
        (jnp.zeros((gp, d), jnp.float32), jnp.full((gp,), _NEG, jnp.float32),
         jnp.zeros((gp,), jnp.float32)))
    o_ref[...] = o
    l_ref[...] = l
    m_ref[...] = m


@functools.partial(
    jax.jit, static_argnames=("scale", "interpret"))
def paged_attention(
    q: jax.Array,             # [B, Hq, D] — one decode token per sequence
    k_pool: jax.Array,        # [L, NB, bs, Hkv, D]
    v_pool: jax.Array,
    block_tables: jax.Array,  # [B, max_blocks] int32
    context_lens: jax.Array,  # [B] int32 (length INCLUDING current token)
    *,
    layer,
    scale: Optional[float] = None,
    k_scale_pool: Optional[jax.Array] = None,  # [L, NB, bs, Hkv] (int8 KV)
    v_scale_pool: Optional[jax.Array] = None,
    interpret: bool = False,
) -> jax.Array:
    """Decode attention over the paged cache → [B, Hq, D].

    Wrapper parity: triton_paged_attention_forward
    attention_kernels.py:1206-1311 (int32 table assert, decode grid).
    ``layer`` may be a traced int32 scalar (used inside lax.scan over layers).
    Head dim must be a power of two of at least 16 (a Triton block rule);
    other inputs raise rather than take another path.
    """
    B, Hq, D = q.shape
    L, NB, bs, Hkv, _ = k_pool.shape
    G = Hq // Hkv
    max_blocks = block_tables.shape[1]
    if block_tables.dtype != jnp.int32:
        raise TypeError("block_tables must be int32")
    if D < 16 or D & (D - 1):
        raise ValueError(f"paged_attention kernel needs a power-of-two head "
                         f"dim >= 16, got {D}")
    if bs & (bs - 1):
        raise ValueError(f"paged_attention kernel needs a power-of-two block "
                         f"size, got {bs}")
    if scale is None:
        scale = D ** -0.5
    quant = k_scale_pool is not None
    ppb, splits, per_split = decode_launch(B, Hkv, max_blocks, bs)
    padded = splits * per_split
    tables = jnp.pad(block_tables, ((0, 0), (0, padded - max_blocks)))

    # query heads of one kv head form the dot's rows: at least 16 of them
    gp = max(16, 1 << (G - 1).bit_length())
    qg = q.reshape(B, Hkv, G, D)
    if gp != G:
        qg = jnp.pad(qg, ((0, 0), (0, 0), (0, gp - G), (0, 0)))
    layer_arr = jnp.asarray(layer, jnp.int32).reshape(1)
    # free reshapes: the kernel addresses (layer, block) as one leading index
    operands = [tables, context_lens.astype(jnp.int32), layer_arr, qg,
                k_pool.reshape(L * NB, bs, Hkv, D),
                v_pool.reshape(L * NB, bs, Hkv, D)]
    whole = pl.BlockSpec()  # the whole array; the kernel indexes it
    in_specs = [whole, whole, whole,
                pl.BlockSpec((None, None, gp, D), lambda b, h, s: (b, h, 0, 0)),
                whole, whole]
    if quant:
        operands += [k_scale_pool.reshape(L * NB, bs, Hkv).astype(jnp.float32),
                     v_scale_pool.reshape(L * NB, bs, Hkv).astype(jnp.float32)]
        in_specs += [whole, whole]

    kernel = functools.partial(
        _decode_kernel, page_size=bs, pages_per_block=ppb,
        pages_per_split=per_split, num_blocks=NB, scale=scale, quant=quant)
    o, l, m = pl.pallas_call(
        kernel,
        grid=(B, Hkv, splits),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((None, None, None, gp, D),
                         lambda b, h, s: (s, b, h, 0, 0)),
            pl.BlockSpec((None, None, None, gp), lambda b, h, s: (s, b, h, 0)),
            pl.BlockSpec((None, None, None, gp), lambda b, h, s: (s, b, h, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((splits, B, Hkv, gp, D), jnp.float32),
            jax.ShapeDtypeStruct((splits, B, Hkv, gp), jnp.float32),
            jax.ShapeDtypeStruct((splits, B, Hkv, gp), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="paged_decode_attention",
    )(*operands)
    # merge the splits' partial softmaxes
    m_all = m.max(axis=0)
    w = jnp.exp(m - m_all[None])
    den = (l * w).sum(axis=0)
    out = (o * w[..., None]).sum(axis=0) / jnp.maximum(den, 1e-30)[..., None]
    return out[:, :, :G].reshape(B, Hq, D).astype(q.dtype)


def paged_attention_reference(q, k_pool, v_pool, block_tables, context_lens,
                              *, layer, scale=None, k_scale_pool=None,
                              v_scale_pool=None):
    """jnp reference: gather the cache densely, run masked attention
    (parity: the PyTorch fallback attention_kernels.py:1519-1626)."""
    from mlio_tpu.ops.reference import attention_reference

    B, Hq, D = q.shape
    L, NB, bs, Hkv, _ = k_pool.shape
    max_blocks = block_tables.shape[1]
    S = max_blocks * bs
    k = k_pool[layer][block_tables].reshape(B, S, Hkv, D)
    v = v_pool[layer][block_tables].reshape(B, S, Hkv, D)
    ks = vs = None
    if k_scale_pool is not None:
        ks = k_scale_pool[layer][block_tables].reshape(B, S, Hkv)
        vs = v_scale_pool[layer][block_tables].reshape(B, S, Hkv)
    out = attention_reference(q.reshape(B, 1, Hq, D), k, v,
                              causal=False, scale=scale, kv_len=context_lens,
                              k_scale=ks, v_scale=vs)
    return out[:, 0]


def contiguous_pages(smax: int) -> int:
    """Page size for viewing a contiguous [.., Smax, ..] cache as pages:
    the largest power of two up to 64 that divides ``smax``."""
    p = 64
    while smax % p:
        p //= 2
    return p


def decode_attention(q, k_cache, v_cache, context_lens, *, layer,
                     k_scales=None, v_scales=None, interpret=False):
    """Decode attention over the contiguous cache [L, B, Smax, Hkv, D].

    The cache is viewed, by a free reshape, as a paged pool whose sequence
    b owns pages b*P .. b*P + P-1, and read by :func:`paged_attention`."""
    L, B, Smax, Hkv, D = k_cache.shape
    page = contiguous_pages(Smax)
    n = Smax // page
    tables = (jnp.arange(B, dtype=jnp.int32)[:, None] * n
              + jnp.arange(n, dtype=jnp.int32)[None, :])
    shape = (L, B * n, page, Hkv, D)
    ks = vs = None
    if k_scales is not None:
        ks = k_scales.reshape(shape[:-1])
        vs = v_scales.reshape(shape[:-1])
    return paged_attention(q, k_cache.reshape(shape), v_cache.reshape(shape),
                           tables, context_lens, layer=layer, k_scale_pool=ks,
                           v_scale_pool=vs, interpret=interpret)
