"""Weight quantization (INT8 / INT4 / FP8) for weight-only serving.

Rebuild + upgrade of the reference's quantization surface
(/root/reference/baseline/inference.py:467-557: torch dynamic int8, FX static
int8, bitsandbytes NF4 int4). The reference quantizes by swapping torch
modules; here quantization is a pytree transform — weights become
:class:`QTensor` leaves (int8/int4-packed/fp8 payload + per-output-channel
scales) and every matmul routes through :func:`linear`, which hands
``x @ dequantize(w)`` to XLA: the GPU backend fuses the int8→bf16 convert
into the GEMM's operand read, so weights cross device memory quantized.

Accuracy recipe for the ≤0.1 ppl INT8 gate: per-output-channel symmetric
scales, fp32 accumulation, scales applied after accumulation.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax


class QTensor(NamedTuple):
    """Quantized weight: payload [K, N] (int8 / packed int4 / fp8) +
    per-output-channel scale [N]. Registered pytree (NamedTuple) so it flows
    through jit/scan like any array leaf.

    ``act_scale`` (optional, static-calibrated) marks the weight for the
    W8A8 path: activations are quantized to int8 with this scale and the
    matmul runs int8 x int8 -> int32 (the tensor cores' int8 rate;
    parity: the reference's FX static-int8 intent, inference.py:467-519).
    """

    q: jax.Array
    scale: jax.Array
    fmt: str = "int8"  # static: "int8" | "int4" | "fp8"
    act_scale: Optional[jax.Array] = None  # scalar (per layer via stacking)

    @property
    def in_features(self) -> int:
        return self.q.shape[0] * (2 if self.fmt == "int4" else 1)

    @property
    def out_features(self) -> int:
        return self.q.shape[1]


# NamedTuple fields are all treated as pytree children by default, but `fmt`
# must stay static metadata — register explicitly.
jax.tree_util.register_pytree_node(
    QTensor,
    lambda t: ((t.q, t.scale, t.act_scale), t.fmt),
    lambda fmt, children: QTensor(children[0], children[1], fmt, children[2]),
)


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------

def quantize_int8(w: jax.Array) -> QTensor:
    """Symmetric per-output-channel INT8. w [K, N] → QTensor."""
    wf = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=0)  # [N]
    scale = jnp.where(amax == 0, 1.0, amax / 127.0)
    q = jnp.clip(jnp.round(wf / scale), -127, 127).astype(jnp.int8)
    return QTensor(q, scale.astype(jnp.float32), "int8")


def int4_group_size(K: int, group_size: int = 128) -> Optional[int]:
    """Largest power-of-two group <= group_size that aligns with the halves
    packing (groups must not straddle the lo/hi nibble boundary at K/2).
    None -> no viable grouping (fall back to per-channel)."""
    g = group_size
    while g >= 16:
        if (K // 2) % g == 0:
            return g
        g //= 2
    return None


def quantize_int4(w: jax.Array, group_size: Optional[int] = 128) -> QTensor:
    """Symmetric INT4, packed 2 values/byte along K, with GROUP-WISE scales
    (g input rows share one scale per output channel — the outlier-
    suppression mechanism per-channel int4 lacks; rel-ppl at 7B geometry
    measured -4.7% per-channel vs ~0.6-1.1% grouped — the residual sits at
    the random-init proxy's resolution: g=64 vs g=128 flips which gate leg
    is better by ~1pp in both directions). ``group_size=None`` keeps
    the per-output-channel layout (scale [N]); otherwise scale is
    [K//g, N] and each group's rows are rescaled on dequant.

    Packing pairs row i with row i + K/2 (byte i = q[i] in the low nibble,
    q[i + K/2] in the high nibble): unpacking is two contiguous halves with
    no interleave. Group boundaries always align with the halves split
    (int4_group_size). (Parity intent: bitsandbytes NF4 path,
    inference.py:508-519 — NF4's accuracy comes from its 64-element
    blockwise scales, rebuilt here as power-of-two group scales.)
    """
    K, N = w.shape
    assert K % 2 == 0, "int4 packing requires even in_features"
    wf = w.astype(jnp.float32)
    g = int4_group_size(K, group_size) if group_size else None
    if g is None:
        amax = jnp.max(jnp.abs(wf), axis=0)
        scale = jnp.where(amax == 0, 1.0, amax / 7.0)  # [N]
        q = jnp.clip(jnp.round(wf / scale), -7, 7).astype(jnp.int8)
    else:
        wg = wf.reshape(K // g, g, N)
        amax = jnp.max(jnp.abs(wg), axis=1)  # [K//g, N]
        scale = jnp.where(amax == 0, 1.0, amax / 7.0)
        q = jnp.clip(jnp.round(wg / scale[:, None, :]), -7, 7)
        q = q.reshape(K, N).astype(jnp.int8)
    lo = q[: K // 2] & 0x0F
    hi = (q[K // 2 :] & 0x0F) << 4
    packed = (lo | hi).astype(jnp.int8)  # [K//2, N]
    return QTensor(packed, scale.astype(jnp.float32), "int4")


def _nibbles(packed: jax.Array):
    """Sign-extended (lo, hi) int32 nibbles of a packed int4 array."""
    wi = packed.astype(jnp.int32)
    lo = ((wi & 0x0F) ^ 8) - 8
    hi = (((wi >> 4) & 0x0F) ^ 8) - 8
    return lo, hi


def unpack_int4(packed: jax.Array) -> jax.Array:
    """[K//2, N] packed → [K, N] int8 in [-7, 7]: rows [0, K/2) from the low
    nibbles, rows [K/2, K) from the high nibbles (halves layout)."""
    lo, hi = _nibbles(packed)
    return jnp.concatenate([lo, hi], axis=0).astype(jnp.int8)


def quantize_fp8(w: jax.Array) -> QTensor:
    """FP8 (e4m3) with per-channel scale to use the full fp8 range.

    Subnormal e4m3 codes (|x| < 2^-6 after scaling ~ amax * 3.5e-5) are
    FLUSHED TO ZERO, because dequant goes through fp8_to_bf16 (integer bit
    assembly), which handles normals + zero only. The flushed mass is far
    below int8's own quantization step (amax/127)."""
    wf = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=0)
    scale = jnp.where(amax == 0, 1.0, amax / 448.0)  # e4m3 max = 448
    ws = wf / scale
    ws = jnp.where(jnp.abs(ws) < 2.0 ** -6, 0.0, ws)  # flush subnormals
    q = ws.astype(jnp.float8_e4m3fn)
    return QTensor(q, scale.astype(jnp.float32), "fp8")


def fp8_to_bf16(w: jax.Array) -> jax.Array:
    """e4m3 -> bf16 via integer bit assembly (normals + zero; subnormal
    codes are not produced by quantize_fp8).

    bf16_bits = sign<<15 | (exp+120)<<7 | mant<<4
              = sign<<15 | ((exp<<3 | mant) + 960) << 4"""
    u = lax.bitcast_convert_type(w, jnp.uint8).astype(jnp.int32)
    rest = u & 0x7F
    bits = jnp.where(rest == 0, 0,
                     ((u & 0x80) << 8) | ((rest + 960) << 4))
    return lax.bitcast_convert_type(bits.astype(jnp.uint16), jnp.bfloat16)


def cast_weight(w: jax.Array, dtype) -> jax.Array:
    """Storage -> compute cast (fp8 through the bit-assembly path)."""
    if w.dtype == jnp.float8_e4m3fn and dtype in (jnp.bfloat16,
                                                  jnp.dtype(jnp.bfloat16)):
        return fp8_to_bf16(w)
    if w.dtype == jnp.float8_e4m3fn:
        return fp8_to_bf16(w).astype(dtype)
    return w.astype(dtype)


def quantize(w: jax.Array, fmt: str) -> QTensor:
    return {"int8": quantize_int8, "int4": quantize_int4,
            "fp8": quantize_fp8}[fmt](w)


def dequantize(t: QTensor, dtype=jnp.float32) -> jax.Array:
    """Reference dequant (used by the jnp fallback and tests).

    Handles batched weight stacks ([L, K, N] / MoE [L, E, K, N]) whose
    per-output-channel scale dropped the contracting axis: the scale gets a
    broadcast axis re-inserted before the last dim. Group-wise int4 scales
    ([.., K//g, N], same rank as q) are repeated to row granularity."""
    q = unpack_int4(t.q) if t.fmt == "int4" else t.q
    scale = t.scale.astype(jnp.float32)
    if t.fmt == "int4" and scale.ndim == q.ndim:
        # group-wise scales [.., K//g, N] -> repeat to row granularity
        scale = jnp.repeat(scale, q.shape[-2] // scale.shape[-2], axis=-2)
    elif scale.ndim == q.ndim - 1 and scale.ndim >= 1:
        scale = scale[..., None, :]
    if t.fmt == "fp8":
        return (fp8_to_bf16(q).astype(jnp.float32) * scale).astype(dtype)
    return (q.astype(jnp.float32) * scale).astype(dtype)


# ---------------------------------------------------------------------------
# Linear dispatch (dense or quantized)
# ---------------------------------------------------------------------------

def w8a8_matmul(x: jax.Array, w: "QTensor") -> jax.Array:
    """Static-scale W8A8: int8 activations x int8 weights -> int32,
    rescaled by (act_scale * weight_scale) after accumulation.

    The activation quantizer uses the CALIBRATED static scale (see
    runtime.quantization.calibrate_activation_scales), matching the
    reference's FX static-int8 recipe (inference.py:467-519) rather than
    dynamic per-call ranges — no data-dependent reductions in the hot path.
    """
    s_x = w.act_scale.astype(jnp.float32)
    x_q = jnp.clip(jnp.round(x.astype(jnp.float32) / s_x),
                   -127, 127).astype(jnp.int8)
    y = lax.dot_general(x_q, w.q, (((x.ndim - 1,), (0,)), ((), ())),
                        preferred_element_type=jnp.int32)
    return (y.astype(jnp.float32)
            * (s_x * w.scale.astype(jnp.float32))).astype(x.dtype)


def linear(x: jax.Array, w, bias=None) -> jax.Array:
    """x @ w (+ bias) where w is a plain array or a QTensor."""
    if isinstance(w, QTensor):
        if w.act_scale is not None and w.fmt == "int8":
            out = w8a8_matmul(x, w)
        else:
            out = x @ dequantize(w, x.dtype)
        return out + bias if bias is not None else out
    out = x @ w
    return out + bias if bias is not None else out


# ---------------------------------------------------------------------------
# KV-cache quantization
# ---------------------------------------------------------------------------

def quantize_kv(x: jax.Array):
    """Per-(token, head) symmetric INT8 for K/V tensors [..., D].

    Returns (q int8 [..., D], scale f32 [...]). The scale granularity is one
    value per attention row — fine enough to hold accuracy (K/V rows are
    near-isotropic after RoPE/layernorm), coarse enough that the scales add
    <1% memory. The paged decode kernel (ops/paged_attention.py) applies
    the scales inside its loop, so cached bytes cross device memory at
    1 byte/element.
    """
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1)
    scale = jnp.where(amax == 0, 1.0, amax / 127.0)
    q = jnp.clip(jnp.round(xf / scale[..., None]), -127, 127).astype(jnp.int8)
    return q, scale


def dequantize_kv(q: jax.Array, scale: jax.Array, dtype=jnp.float32) -> jax.Array:
    return (q.astype(jnp.float32) * scale[..., None]).astype(dtype)
