"""Per-kernel validation + benchmark surface.

Reference parity: every Triton kernel module in the reference ships inline
``validate_*`` / ``benchmark_*`` / ``compare_with_*`` functions
(validate_fused_mlp /root/reference/kernels/triton/mlp_kernels.py:925,
benchmark_fused_mlp mlp_kernels.py:810, profile_memory_usage
mlp_kernels.py:1003, benchmark_flash_attention_speed
/root/reference/kernels/attention/flash_attention.py:1171,
compare_with_standard_attention flash_attention_kernels.py:1876). This module
centralizes them: each kernel path is diffed against its pure-jnp twin
(:mod:`mlio_tpu.ops.reference`) computed in float32 at the highest matmul
precision (an f32 matmul on the GPU may otherwise run in TF32).

Every ``validate_*`` takes the widths to check at, the input dtype and
``interpret`` (Pallas interpret mode, for CPU tests; on the card it is
False). It returns a plain dict with the max-abs error, the tolerance and the
reason for that tolerance.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Sequence

import jax
import jax.numpy as jnp

from mlio_tpu.models.transformer import Impl
from mlio_tpu import ops
from mlio_tpu.ops.reference import attention_reference

# Tolerances by input dtype. f32: the kernels run f32 dots without TF32,
# so only summation order differs. bf16: inputs are the same bf16 values on
# both sides, so the error is the kernel's bf16 rounding of probabilities
# and output (2^-8 relative on values of order 1).
TOLERANCE = {
    jnp.dtype(jnp.float32): (1e-3, "f32 inputs, f32 accumulation: "
                                   "summation order only"),
    jnp.dtype(jnp.bfloat16): (2e-2, "bf16 inputs: bf16 rounding of "
                                    "probabilities and output (2^-8 rel)"),
}


def _max_diff(a: jax.Array, b: jax.Array) -> float:
    return float(jnp.max(jnp.abs(a.astype(jnp.float32)
                                 - b.astype(jnp.float32))))


def _verdict(name: str, diff: float, dtype, extra=None) -> Dict:
    t, reason = TOLERANCE[jnp.dtype(dtype)]
    out = {"kernel": name, "max_abs_diff": diff, "tol": t, "reason": reason,
           "dtype": jnp.dtype(dtype).name, "passed": bool(diff < t)}
    if extra:
        out.update(extra)
    return out


def _f32(*xs):
    return [x.astype(jnp.float32) for x in xs]


def _compiled_call(fn, *args):
    """Compile ``fn`` for ``args`` once, run it; returns (output, the
    compiled executable's memory analysis as a dict of bytes)."""
    compiled = jax.jit(fn).lower(*args).compile()
    mem = compiled.memory_analysis()
    stats = {} if mem is None else {
        "argument_bytes": mem.argument_size_in_bytes,
        "output_bytes": mem.output_size_in_bytes,
        "temp_bytes": mem.temp_size_in_bytes}
    return compiled(*args), stats


def benchmark_op(fn: Callable[..., jax.Array], *args, short: int = 16,
                 long: int = 48) -> Dict:
    """Time one op with the two-length scan marginal.

    Runs ``lax.scan`` of ``fn(*args)`` (must return an array) at ``short``
    and ``long`` iterations inside a single jit each, and reports
    ``(t_long - t_short) / (long - short)``, which cancels dispatch, launch
    and host-sync costs. ``args`` are passed to the jit as arguments (a
    closed-over array would be embedded in the program as a constant). The
    scan carries a perturbation into the first argument, so XLA can neither
    hoist the op out of the loop nor drop it, and the result is reduced to a
    scalar before fetching.
    """

    def make(n):
        @jax.jit
        def run(*args):
            def body(c, _):
                if args:
                    y = fn(args[0] + c.astype(args[0].dtype), *args[1:])
                else:
                    y = fn()
                # fold the (scalar-reduced) output back into the carry so
                # each iteration depends on the previous one
                return c + jnp.sum(y).astype(jnp.float32) * 1e-30, None

            c, _ = jax.lax.scan(body, jnp.float32(0), None, length=n)
            return c

        return run

    run_s, run_l = make(short), make(long)
    float(run_s(*args))  # compile + warm both
    float(run_l(*args))
    t0 = time.perf_counter()
    float(run_s(*args))
    ts = time.perf_counter() - t0
    t0 = time.perf_counter()
    float(run_l(*args))
    tl = time.perf_counter() - t0
    per_iter = max((tl - ts) / (long - short), 1e-9)
    return {"seconds_per_call": per_iter, "calls_per_sec": 1.0 / per_iter}


def _mk(rng, shape, dtype):
    return jax.random.normal(rng, shape, jnp.float32).astype(dtype)


# ---------------------------------------------------------------------------
# Attention


def validate_flash_attention(batch=2, seq=256, heads=4, head_dim=64,
                             kv_heads=None, causal=True, q_offset=0,
                             dtype=jnp.bfloat16, interpret=False) -> Dict:
    """Flash path (cuDNN) vs dense reference (parity:
    compare_with_standard_attention flash_attention_kernels.py:1876).
    ``q_offset > 0`` places the queries after that much cached context."""
    kv_heads = kv_heads or heads
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    skv = seq + q_offset
    q = _mk(ks[0], (batch, seq, heads, head_dim), dtype)
    k = _mk(ks[1], (batch, skv, kv_heads, head_dim), dtype)
    v = _mk(ks[2], (batch, skv, kv_heads, head_dim), dtype)
    impl = Impl(attention="flash", interpret=interpret)
    out, mem = _compiled_call(lambda q, k, v: ops.attention(
        q, k, v, causal=causal, q_offset=q_offset, impl=impl), q, k, v)
    with jax.default_matmul_precision("highest"):
        ref = attention_reference(*_f32(q, k, v), causal=causal,
                                  q_offset=q_offset)
    return _verdict("flash_attention", _max_diff(out, ref), dtype,
                    {"shape": [batch, seq, heads, head_dim],
                     "gqa_groups": heads // kv_heads, "q_offset": q_offset,
                     "memory": mem})


def benchmark_flash_attention_speed(batch=2, seq=1024, heads=8, head_dim=64,
                                    dtype=jnp.bfloat16,
                                    interpret=False) -> Dict:
    """Flash vs dense timing + achieved FLOPs (parity:
    benchmark_flash_attention_speed flash_attention.py:1171)."""
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    q = _mk(ks[0], (batch, seq, heads, head_dim), dtype)
    k = _mk(ks[1], (batch, seq, heads, head_dim), dtype)
    v = _mk(ks[2], (batch, seq, heads, head_dim), dtype)
    impl = Impl(attention="flash", interpret=interpret)
    t_flash = benchmark_op(lambda q, k, v: ops.attention(q, k, v, impl=impl),
                           q, k, v)
    t_dense = benchmark_op(lambda q, k, v: ops.attention(q, k, v), q, k, v)
    flops = 4 * batch * heads * seq * seq * head_dim  # QK^T + PV, causal ~/2
    return {
        "kernel": "flash_attention",
        "shape": [batch, seq, heads, head_dim],
        "flash_seconds": t_flash["seconds_per_call"],
        "dense_seconds": t_dense["seconds_per_call"],
        "speedup": t_dense["seconds_per_call"] / t_flash["seconds_per_call"],
        "flash_tflops": flops / t_flash["seconds_per_call"] / 1e12,
    }


def benchmark_attention_memory(batch=1, heads=8, head_dim=64,
                               seqs: Sequence[int] = (512, 1024, 2048)) -> Dict:
    """Theoretical memory: dense materializes the [Sq, Skv] score matrix,
    flash keeps O(block) (parity: benchmark_memory_usage
    flash_attention.py:1282 and FA3's memory model :409-460)."""
    rows = []
    for s in seqs:
        dense = batch * heads * s * s * 4  # fp32 scores
        flash = batch * heads * 3 * s * head_dim * 2  # q,k,v tiles resident
        rows.append({"seq": s, "dense_bytes": dense, "flash_bytes": flash,
                     "reduction": dense / max(flash, 1)})
    return {"kernel": "flash_attention", "memory": rows}


def validate_ring_attention(batch=1, seq=512, heads=4, head_dim=64,
                            chunk=128, dtype=jnp.float32, **_) -> Dict:
    """Chunked ring attention vs dense — the global online-softmax property
    the reference's module-level ring got wrong (SURVEY §2.9.12; correct
    kernel parity: attention_kernels.py:36-202)."""
    ks = jax.random.split(jax.random.PRNGKey(4), 3)
    q = _mk(ks[0], (batch, seq, heads, head_dim), dtype)
    k = _mk(ks[1], (batch, seq, heads, head_dim), dtype)
    v = _mk(ks[2], (batch, seq, heads, head_dim), dtype)
    impl = Impl(attention="ring", ring_chunk=chunk)
    with jax.default_matmul_precision("highest"):
        out = ops.attention(q, k, v, causal=True, impl=impl)
        ref = attention_reference(*_f32(q, k, v), causal=True)
    return _verdict("ring_attention", _max_diff(out, ref), dtype,
                    {"chunk": chunk})


def validate_paged_attention(batch=2, heads=4, kv_heads=2, head_dim=64,
                             block_size=16, ctx=100, max_blocks=8, layers=2,
                             dtype=jnp.float32, interpret=False) -> Dict:
    """Paged decode kernel over scattered block tables and ragged contexts
    (one sequence at ``ctx``, the others shorter) vs the dense reference
    over the gathered cache (parity: _paged_attention_fwd_kernel
    attention_kernels.py:628-808)."""
    from mlio_tpu.ops.paged_attention import (paged_attention,
                                              paged_attention_reference)

    ks = jax.random.split(jax.random.PRNGKey(5), 4)
    nb = batch * max_blocks + 1
    q = _mk(ks[0], (batch, heads, head_dim), dtype)
    kp = _mk(ks[1], (layers, nb, block_size, kv_heads, head_dim), dtype)
    vp = _mk(ks[2], (layers, nb, block_size, kv_heads, head_dim), dtype)
    # distinct physical blocks per sequence, shuffled
    table = (1 + jax.random.permutation(ks[3], nb - 1)[: batch * max_blocks]
             ).reshape(batch, max_blocks).astype(jnp.int32)
    ctx_lens = jnp.maximum(ctx - 37 * jnp.arange(batch), 1).astype(jnp.int32)
    layer = layers - 1
    out, mem = _compiled_call(
        lambda *a: paged_attention(*a, layer=layer, interpret=interpret),
        q, kp, vp, table, ctx_lens)
    with jax.default_matmul_precision("highest"):
        ref = paged_attention_reference(*_f32(q, kp, vp), table, ctx_lens,
                                        layer=layer)
    return _verdict("paged_attention", _max_diff(out, ref), dtype,
                    {"ctx": ctx, "block_size": block_size,
                     "shape": [batch, heads, kv_heads, head_dim],
                     "memory": mem})


def validate_decode_attention(batch=2, heads=4, kv_heads=2, head_dim=64,
                              smax=256, ctx=200, layers=2, kv_int8=False,
                              dtype=jnp.float32, interpret=False) -> Dict:
    """The paged kernel over the contiguous generate cache (viewed as pages)
    vs masked dense attention over the layer's cache. ``kv_int8`` stores
    the cache as int8 with per-(token, head) scales; the reference reads
    the same int8 values dequantized (exact in f32)."""
    from mlio_tpu.ops.paged_attention import decode_attention
    from mlio_tpu.ops.quant import dequantize_kv, quantize_kv

    ks = jax.random.split(jax.random.PRNGKey(6), 3)
    q = _mk(ks[0], (batch, heads, head_dim), dtype)
    kc = _mk(ks[1], (layers, batch, smax, kv_heads, head_dim), dtype)
    vc = _mk(ks[2], (layers, batch, smax, kv_heads, head_dim), dtype)
    ctx_lens = jnp.maximum(ctx - 53 * jnp.arange(batch), 1).astype(jnp.int32)
    layer = layers - 1
    scales = {}
    if kv_int8:
        kc, k_s = quantize_kv(kc)
        vc, v_s = quantize_kv(vc)
        scales = {"k_scales": k_s, "v_scales": v_s}
    out, mem = _compiled_call(
        lambda q, kc, vc, c, sc: decode_attention(
            q, kc, vc, c, layer=layer, interpret=interpret, **sc),
        q, kc, vc, ctx_lens, scales)
    kl, vl = kc[layer], vc[layer]
    if kv_int8:
        kl = dequantize_kv(kl, scales["k_scales"][layer])
        vl = dequantize_kv(vl, scales["v_scales"][layer])
    with jax.default_matmul_precision("highest"):
        qf, kf, vf = _f32(q, kl, vl)
        ref = attention_reference(qf[:, None], kf, vf, causal=False,
                                  kv_len=ctx_lens)[:, 0]
    return _verdict("decode_attention" + ("_int8kv" if kv_int8 else ""),
                    _max_diff(out, ref), dtype,
                    {"ctx": ctx, "smax": smax,
                     "shape": [batch, heads, kv_heads, head_dim],
                     "memory": mem})


# ---------------------------------------------------------------------------
# MLP, quantized linear, MoE


def profile_mlp_memory(batch=4, seq=512, hidden=1024,
                       intermediate=4096) -> Dict:
    """Memory-traffic model: an unfused MLP writes and re-reads the
    [*, intermediate] activation; one whose activation is fused into the
    up-projection's epilogue (as XLA's GPU backend does) does not (parity:
    profile_memory_usage mlp_kernels.py:1003; the reference README's
    40-60% bandwidth-reduction claim)."""
    tokens = batch * seq
    weights = (2 * hidden * intermediate) * 2
    io = tokens * hidden * 2 * 2
    inter = tokens * intermediate * 2 * 2  # write + read, bf16
    unfused, fused = weights + io + inter, weights + io
    return {"kernel": "mlp", "unfused_bytes": unfused,
            "fused_bytes": fused,
            "bandwidth_reduction": 1 - fused / unfused}


def _mlp_weights(hidden, intermediate, activation, dtype, seed=1):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    s = hidden ** -0.5
    w_up = _mk(ks[0], (hidden, intermediate), jnp.float32) * s
    w_down = _mk(ks[1], (intermediate, hidden), jnp.float32) * s
    gated = activation in ("swiglu", "geglu")
    w_gate = _mk(ks[2], (hidden, intermediate), jnp.float32) * s if gated \
        else None
    cast = lambda w: None if w is None else w.astype(dtype)
    return cast(w_up), cast(w_down), cast(w_gate)


def benchmark_fused_mlp(batch=4, seq=512, hidden=1024, intermediate=4096,
                        activation="swiglu", dtype=jnp.bfloat16) -> Dict:
    """MLP timing with bf16 weights vs int8 weight-only weights (the int8
    path dequantizes into the GEMM's operand read; parity:
    benchmark_fused_mlp mlp_kernels.py:810)."""
    from mlio_tpu.ops.quant import quantize_int8

    x = _mk(jax.random.PRNGKey(0), (batch, seq, hidden), dtype)
    w_up, w_down, w_gate = _mlp_weights(hidden, intermediate, activation,
                                        dtype)
    q = [None if w is None else quantize_int8(w) for w in
         (w_up, w_down, w_gate)]
    t_b = benchmark_op(lambda x, u, d, g: ops.mlp(
        x, u, d, w_gate=g, activation=activation), x, w_up, w_down, w_gate)
    t_q = benchmark_op(lambda x, u, d, g: ops.mlp(
        x, u, d, w_gate=g, activation=activation), x, *q)
    return {"kernel": f"mlp_{activation}",
            "shape": [batch, seq, hidden, intermediate],
            "bf16_seconds": t_b["seconds_per_call"],
            "int8_seconds": t_q["seconds_per_call"],
            "int8_over_bf16": t_q["seconds_per_call"]
            / t_b["seconds_per_call"]}


def validate_quant_linear(m=64, k=256, n=512, fmt="int8",
                          dtype=jnp.bfloat16) -> Dict:
    """``ops.linear`` on a quantized weight vs ``x @ dequantize(w)`` in f32
    (the dequantized weight is exact; the error is the GEMM's)."""
    from mlio_tpu.ops.quant import dequantize, quantize

    ks = jax.random.split(jax.random.PRNGKey(7), 2)
    x = _mk(ks[0], (m, k), dtype)
    w = quantize(_mk(ks[1], (k, n), jnp.float32) * k ** -0.5, fmt)
    out = jax.jit(lambda x, w: ops.linear(x, w))(x, w)
    with jax.default_matmul_precision("highest"):
        ref = x.astype(jnp.float32) @ dequantize(w, jnp.float32)
    # bf16 output of a K-long dot with O(1) results
    return _verdict(f"quant_linear_{fmt}", _max_diff(out, ref), dtype,
                    {"shape": [m, k, n]})


def validate_moe(tokens=64, hidden=128, intermediate=256, experts=8, top_k=2,
                 dtype=jnp.bfloat16) -> Dict:
    """Dropless ragged MoE (``ragged_dot`` grouped matmul) vs the
    all-experts dense oracle in f32."""
    ks = jax.random.split(jax.random.PRNGKey(8), 5)
    s = hidden ** -0.5
    x = _mk(ks[0], (tokens, hidden), dtype)
    router = (_mk(ks[1], (hidden, experts), jnp.float32) * s).astype(dtype)
    w_gate = (_mk(ks[2], (experts, hidden, intermediate), jnp.float32) * s
              ).astype(dtype)
    w_up = (_mk(ks[3], (experts, hidden, intermediate), jnp.float32) * s
            ).astype(dtype)
    w_down = (_mk(ks[4], (experts, intermediate, hidden), jnp.float32)
              * intermediate ** -0.5).astype(dtype)
    out = jax.jit(lambda *a: ops.moe_mlp(*a, top_k=top_k,
                                         method="ragged"))(
        x, router, w_gate, w_up, w_down)
    with jax.default_matmul_precision("highest"):
        ref = ops.moe_mlp(*_f32(x, router, w_gate, w_up, w_down),
                          top_k=top_k, method="dense")
    return _verdict("moe_ragged", _max_diff(out, ref), dtype,
                    {"shape": [tokens, hidden, intermediate, experts]})


def validate_all(interpret: bool = False) -> Dict[str, Dict]:
    """Run every kernel's correctness gate at small widths;
    returns {kernel: verdict}."""
    results = [
        validate_flash_attention(interpret=interpret),
        validate_ring_attention(),
        validate_paged_attention(interpret=interpret),
        validate_decode_attention(interpret=interpret),
        validate_quant_linear(),
        validate_moe(),
    ]
    return {r["kernel"]: r for r in results}


__all__ = [
    "TOLERANCE",
    "benchmark_op",
    "validate_flash_attention",
    "benchmark_flash_attention_speed",
    "benchmark_attention_memory",
    "profile_mlp_memory",
    "benchmark_fused_mlp",
    "validate_ring_attention",
    "validate_paged_attention",
    "validate_decode_attention",
    "validate_quant_linear",
    "validate_moe",
    "validate_all",
]
