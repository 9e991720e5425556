"""Ring / chunked attention with mathematically correct online-softmax merge.

Rebuild of the reference's ring attention
(/root/reference/kernels/attention/ring_attention.py:92-669 and the Triton
kernel /root/reference/kernels/triton/attention_kernels.py:36-202). The
reference's module-level implementations apply softmax per chunk and sum —
admitted-incorrect (ring_attention.py:359-372, sequence_parallel.py:564-583;
SURVEY.md §2.9.12). Here EVERY path uses the running (m, l, acc) merge:

    m'   = max(m, max_j s_j)
    acc' = acc * exp(m - m') + exp(s - m') v
    l'   = l * exp(m - m') + sum_j exp(s_j - m')

which is the blockwise-softmax recurrence of flash attention, applied across
chunks/devices.

Single-device :func:`chunked_ring_attention` bounds memory to
O(S_q * chunk) — the "65K+ context" capability (reference README.md:95-102).
The distributed version (K/V rotating around the device ring via ppermute) lives
in :mod:`mlio_tpu.parallel.sequence_parallel` and shares :func:`chunk_step`.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

NEG_INF = float("-inf")


def chunk_step(
    q: jax.Array,          # [B, Sq, Hq, D] fp32
    k: jax.Array,          # [B, C, Hkv, D]
    v: jax.Array,          # [B, C, Hkv, D]
    m: jax.Array,          # [B, Hq, Sq, 1] running max
    l: jax.Array,          # [B, Hq, Sq, 1] running normalizer
    acc: jax.Array,        # [B, Hq, Sq, D] running output
    *,
    scale: float,
    q_positions: jax.Array,   # [Sq] absolute positions of q rows
    k_positions: jax.Array,   # [C] absolute positions of this chunk's keys
    causal: bool,
    kv_len=None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One (m, l, acc) accumulation step against a single K/V chunk."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    kf = k.astype(jnp.float32)
    vf = v.astype(jnp.float32)
    if group > 1:
        kf = jnp.repeat(kf, group, axis=2)
        vf = jnp.repeat(vf, group, axis=2)

    s = jnp.einsum("bqhd,bkhd->bhqk", q, kf) * scale  # [B, Hq, Sq, C]

    mask = None
    if causal:
        mask = q_positions[:, None] >= k_positions[None, :]  # [Sq, C]
        mask = mask[None, None]
    if kv_len is not None:
        valid = k_positions[None, :] < jnp.reshape(jnp.asarray(kv_len), (-1, 1))
        valid = valid[:, None, None, :]  # [B|1, 1, 1, C]
        mask = valid if mask is None else jnp.logical_and(mask, valid)
    if mask is not None:
        s = jnp.where(mask, s, NEG_INF)

    m_new = jnp.maximum(m, jnp.max(s, axis=-1, keepdims=True))
    m_safe = jnp.where(jnp.isneginf(m_new), 0.0, m_new)
    alpha = jnp.where(jnp.isneginf(m), 0.0, jnp.exp(m - m_safe))
    p = jnp.exp(s - m_safe)
    if mask is not None:
        p = jnp.where(mask, p, 0.0)
    l_new = l * alpha + jnp.sum(p, axis=-1, keepdims=True)
    acc_new = acc * alpha + jnp.einsum("bhqk,bkhd->bhqd", p, vf)
    return m_new, l_new, acc_new


def finalize(m, l, acc, dtype) -> jax.Array:
    """(m, l, acc) → attention output [B, Sq, Hq, D]."""
    l_safe = jnp.where(l == 0.0, 1.0, l)
    out = (acc / l_safe).transpose(0, 2, 1, 3)
    return out.astype(dtype)


def init_stats(B, Hq, Sq, D):
    return (jnp.full((B, Hq, Sq, 1), NEG_INF, jnp.float32),
            jnp.zeros((B, Hq, Sq, 1), jnp.float32),
            jnp.zeros((B, Hq, Sq, D), jnp.float32))


@functools.partial(
    jax.jit,
    static_argnames=("causal", "scale", "chunk_size"),
)
def chunked_ring_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset=0,
    kv_len=None,
    chunk_size: int = 512,
) -> jax.Array:
    """Single-device chunked attention: K/V walked chunk-by-chunk with the
    online merge — O(Sq * chunk) score memory regardless of Skv.

    Parity: RingSelfAttention's single-device chunk schedule
    (ring_attention.py:275-410) with the softmax done RIGHT.
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if scale is None:
        scale = D ** -0.5
    C = min(chunk_size, Skv)
    pad = (-Skv) % C
    if pad:
        k = jnp.pad(k, ((0, 0), (0, pad), (0, 0), (0, 0)))
        v = jnp.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
        # padded tail masked via kv_len
        kv_len = jnp.asarray(Skv if kv_len is None else kv_len)
    n_chunks = (Skv + pad) // C

    qf = q.astype(jnp.float32)
    q_pos = jnp.arange(Sq) + q_offset
    kr = k.reshape(B, n_chunks, C, Hkv, D).transpose(1, 0, 2, 3, 4)
    vr = v.reshape(B, n_chunks, C, Hkv, D).transpose(1, 0, 2, 3, 4)

    def body(carry, inputs):
        m, l, acc = carry
        ci, kc, vc = inputs
        k_pos = ci * C + jnp.arange(C)
        m, l, acc = chunk_step(qf, kc, vc, m, l, acc, scale=scale,
                               q_positions=q_pos, k_positions=k_pos,
                               causal=causal, kv_len=kv_len)
        return (m, l, acc), None

    (m, l, acc), _ = lax.scan(body, init_stats(B, Hq, Sq, D),
                              (jnp.arange(n_chunks), kr, vr))
    return finalize(m, l, acc, q.dtype)


def ring_cross_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    scale: Optional[float] = None,
    kv_len=None,
    chunk_size: int = 512,
) -> jax.Array:
    """Cross attention (encoder-decoder: queries attend to a DIFFERENT
    sequence) with chunked K/V and the exact online merge.

    Parity: RingCrossAttention (/root/reference/kernels/attention/
    ring_attention.py:413-669). The reference walks k-chunks, concatenates
    scores, and re-walks value chunks to get a global softmax
    (:597-660); the (m, l, acc) recurrence here gives the identical result
    in one pass without materializing the full score row."""
    return chunked_ring_attention(q, k, v, causal=False, scale=scale,
                                  kv_len=kv_len, chunk_size=chunk_size)


def ring_attention_memory_model(batch, heads, sq, skv, d, world_size,
                                dtype_bytes=2):
    """Per-device memory model (parity: get_effective_bytes_per_token
    ring_attention.py:128): K/V resident per device is Skv/world, vs full
    Skv for dense — linear scaling in #devices."""
    kv_local = 2 * batch * (skv // max(1, world_size)) * heads * d * dtype_bytes
    kv_full = 2 * batch * skv * heads * d * dtype_bytes
    return {"kv_bytes_per_device": kv_local, "kv_bytes_dense": kv_full,
            "savings_factor": world_size}
