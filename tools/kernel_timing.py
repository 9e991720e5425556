#!/usr/bin/env python
"""Times each hand-written or library kernel against what XLA makes of the
plain version, on one GPU, at Llama-3-8B widths (32 query heads, 8 KV heads,
head dim 128, hidden 4096, SwiGLU 14336), in one process and in turns.

Kernel rows use the two-length scan marginal of ``ops.validation.benchmark_op``
(launch and host costs cancel). End-to-end rows time ``generate``'s decode
step and the engine's decode step (``runtime.paged_forward.decode_paged``)
with ``Impl()`` (XLA) and ``Impl(attention="flash")`` (the kernels), in the
order plain, kernel, kernel, plain, beside the weight+KV bytes bound at the
card's published memory bandwidth. Writes JSON lines to
``chiprun_out/kernel_timing.jsonl`` and a summary to standard output.

    python tools/kernel_timing.py [--quick]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mlio_tpu import ops  # noqa: E402
from mlio_tpu.models import Impl, load_model  # noqa: E402
from mlio_tpu.ops.paged_attention import (decode_attention,  # noqa: E402
                                          paged_attention,
                                          paged_attention_reference)
from mlio_tpu.ops.reference import attention_reference  # noqa: E402
from mlio_tpu.ops.validation import benchmark_op  # noqa: E402
from mlio_tpu.utils.peaks import device_peaks  # noqa: E402

HQ, HKV, D = 32, 8, 128
FLASH = Impl(attention="flash")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Sink:
    def __init__(self, path: Path, card: str):
        path.parent.mkdir(parents=True, exist_ok=True)
        self.f = path.open("w")
        self.card = card

    def __call__(self, **row):
        row["card"] = self.card
        self.f.write(json.dumps(row) + "\n")
        self.f.flush()
        print(json.dumps(row), flush=True)


def us(fn, *args) -> float:
    try:
        return benchmark_op(fn, *args, short=16,
                            long=80)["seconds_per_call"] * 1e6
    except Exception as e:  # one cell out of memory must not end the run
        print(f"  failed: {type(e).__name__}: {str(e)[:200]}", flush=True)
        return float("nan")


def bf16(key, shape):
    return jax.random.normal(key, shape, jnp.float32).astype(jnp.bfloat16)


def decode_kernels(out, ctxs):
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    B, smax, L = 8, 4096, 2
    q = bf16(ks[0], (B, HQ, D))
    kc = bf16(ks[1], (L, B, smax, HKV, D))
    vc = bf16(ks[2], (L, B, smax, HKV, D))
    from jax.experimental.pallas.ops.gpu import decode_attention as lib
    for ctx in ctxs:
        c = jnp.full((B,), ctx, jnp.int32)
        t_k = us(lambda q, k, v, c: decode_attention(q, k, v, c, layer=1),
                 q, kc, vc, c)
        t_x = us(lambda q, k, v, c: attention_reference(
            q[:, None], k[1], v[1], causal=False, kv_len=c), q, kc, vc, c)
        t_l = us(lambda q, k, v, c: lib.gqa(q, k, v, kv_seq_len=c),
                 q, kc[1], vc[1], c)
        out(kind="decode_attention", B=B, smax=smax, ctx=ctx,
            kernel_us=t_k, xla_masked_us=t_x, library_gqa_us=t_l)
    bs, maxb = 16, 256
    nb = B * maxb + 1
    kp = bf16(ks[1], (L, nb, bs, HKV, D))
    vp = bf16(ks[2], (L, nb, bs, HKV, D))
    tables = jnp.asarray(np.random.default_rng(0).permutation(
        np.arange(1, nb))[: B * maxb].reshape(B, maxb), jnp.int32)
    for ctx in ctxs:
        c = jnp.full((B,), ctx, jnp.int32)
        t_k = us(lambda *a: paged_attention(*a, layer=1),
                 q, kp, vp, tables, c)
        t_x = us(lambda *a: paged_attention_reference(*a, layer=1),
                 q, kp, vp, tables, c)
        out(kind="paged_attention", B=B, block=bs, max_blocks=maxb, ctx=ctx,
            kernel_us=t_k, xla_gather_us=t_x)


def prefill_kernels(out, cells):
    from jax.experimental.pallas.ops.gpu import attention as lib
    for B, S in cells:
        ks = jax.random.split(jax.random.PRNGKey(1), 3)
        q = bf16(ks[0], (B, S, HQ, D))
        k = bf16(ks[1], (B, S, HKV, D))
        v = bf16(ks[2], (B, S, HKV, D))
        t_c = us(lambda q, k, v: ops.attention(q, k, v, causal=True,
                                               impl=FLASH), q, k, v)
        kr, vr = jnp.repeat(k, HQ // HKV, 2), jnp.repeat(v, HQ // HKV, 2)
        t_l = us(lambda q, k, v: lib.mha(q, k, v, None, sm_scale=D ** -0.5,
                                         causal=True), q, kr, vr)
        del kr, vr
        t_x = us(lambda q, k, v: jax.nn.dot_product_attention(
            q, k, v, is_causal=True, implementation="xla"), q, k, v)
        flops = 2 * 2 * B * HQ * S * S * D / 2  # causal half
        out(kind="prefill_attention", B=B, S=S, cudnn_us=t_c,
            library_mha_us=t_l, xla_us=t_x,
            cudnn_tflops=flops / t_c / 1e6 if t_c == t_c else None)


def norm_and_quant(out):
    from jax.experimental.pallas.ops.gpu.rms_norm import rms_norm
    from mlio_tpu.ops.quant import quantize_int8
    ks = jax.random.split(jax.random.PRNGKey(2), 3)
    x = bf16(ks[0], (8 * 2048, 4096))
    w = jnp.ones((4096,), jnp.bfloat16)
    b = jnp.zeros((4096,), jnp.bfloat16)
    t_l = us(rms_norm, x.reshape(8, 2048, 4096), w, b)  # [B, S, H] input
    t_x = us(lambda x, w: ops.norm(x, w, kind="rmsnorm"), x, w)
    out(kind="rmsnorm", tokens=8 * 2048, hidden=4096, library_triton_us=t_l,
        xla_us=t_x)
    wb = bf16(ks[1], (4096, 14336)) * 0.02
    wq = quantize_int8(wb)
    t_b = us(ops.linear, x, wb)
    t_q = us(ops.linear, x, wq)
    out(kind="int8_prefill_matmul", M=8 * 2048, K=4096, N=14336,
        bf16_us=t_b, int8_dequant_in_gemm_us=t_q)


def end_to_end(out, quick: bool):
    from mlio_tpu.runtime import generate
    from mlio_tpu.runtime.paged_forward import decode_paged

    spec, params = load_model("llama3-8b", dtype=jnp.bfloat16, seed=0)
    peaks = device_peaks()
    weight_bytes = spec.num_params() * 2
    B, S, T = 8, 1024, 128 if not quick else 16
    prompts = jnp.asarray(np.random.default_rng(0).integers(
        0, spec.vocab_size, (B, S)), jnp.int32)

    def gen_step(impl):
        kw = dict(impl=impl, cache_len=S + T)
        for n in (T, 1):
            generate(params, spec, prompts, max_new_tokens=n,
                     **kw).block_until_ready()
        t0 = time.perf_counter()
        generate(params, spec, prompts, max_new_tokens=T,
                 **kw).block_until_ready()
        t_all = time.perf_counter() - t0
        t0 = time.perf_counter()
        generate(params, spec, prompts, max_new_tokens=1,
                 **kw).block_until_ready()
        return (t_all - (time.perf_counter() - t0)) / (T - 1)

    kv_gen = 2 * spec.num_layers * B * (S + T // 2) * spec.kv_dim * 2
    for name, impl in (("xla", Impl()), ("kernel", FLASH),
                       ("kernel", FLASH), ("xla", Impl())):
        step = gen_step(impl)
        out(kind="generate_decode_step", path=name, B=B, prompt=S, new=T,
            step_ms=step * 1e3,
            bytes_bound_ms=(weight_bytes + kv_gen) / peaks.hbm_bytes_per_s
            * 1e3)

    # the engine's decode step: 8 sequences at context ctx in paged pools
    bs, max_seq = 16, 2176
    maxb = max_seq // bs
    nb = B * maxb + 1
    from mlio_tpu.ops.paged_attention import init_kv_pools
    tables = jnp.asarray(1 + np.arange(B * maxb).reshape(B, maxb), jnp.int32)
    toks = jnp.zeros((B,), jnp.int32)
    for ctx in (512, 1100, 2048):
        c = jnp.full((B,), ctx, jnp.int32)
        kv_eng = 2 * spec.num_layers * B * ctx * spec.kv_dim * 2
        for name, impl in (("xla", Impl()), ("kernel", FLASH),
                           ("kernel", FLASH), ("xla", Impl())):
            kp, vp = init_kv_pools(spec.num_layers, nb, spec.num_kv_heads,
                                   bs, spec.head_size)
            for _ in range(3):
                _, kp, vp = decode_paged(params, spec, toks, kp, vp, tables,
                                         c, impl=impl)
            jax.block_until_ready(kp)
            n = 20
            t0 = time.perf_counter()
            for _ in range(n):
                logits, kp, vp = decode_paged(params, spec, toks, kp, vp,
                                              tables, c, impl=impl)
            jax.block_until_ready(logits)
            step = (time.perf_counter() - t0) / n
            del kp, vp
            out(kind="engine_decode_step", path=name, B=B, ctx=ctx,
                block=bs, max_blocks=maxb, step_ms=step * 1e3,
                bytes_bound_ms=(weight_bytes + kv_eng)
                / peaks.hbm_bytes_per_s * 1e3)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default="decode,prefill,norm,e2e")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        print("kernel_timing: needs a GPU", file=sys.stderr)
        return 2
    out = Sink(REPO / "chiprun_out" / "kernel_timing.jsonl", card())
    only = set(args.only.split(","))
    if "decode" in only:
        decode_kernels(out, (512, 2048, 4000))
    if "prefill" in only:
        prefill_kernels(out, [(1, 1024), (8, 1024), (1, 4096), (8, 4096),
                              (1, 16384), (8, 16384)])
    if "norm" in only:
        norm_and_quant(out)
    if "e2e" in only:
        end_to_end(out, args.quick)
    return 0


if __name__ == "__main__":
    sys.exit(main())
