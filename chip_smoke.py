#!/usr/bin/env python
"""Bring-up check of the main path on one NVIDIA GPU.

In one process on one card, at Llama-3-8B's published widths (random bf16
weights from ``--seed``):

  1. device   - the platform must be "gpu"; the card's name and power limit;
                the compile-cache directory.
  2. kernels  - every kernel compiled for the card, and the ops entry points
                (quantized linear, ragged MoE, ring attention), at real
                widths against the float32 reference.
  3. generate - B=8, 1024-token prompts, 128 new tokens; decode-path logits
                against a float32 re-scoring of the same sequences; step time.
  4. engine   - 16 requests of 32-2048 prompt tokens and 64-128 new tokens
                through InferenceEngine (max_batch=8); every request must
                finish with its token count, and every greedy token's
                float32 logit must lie within the tolerance of its row's
                maximum; tokens/s and time to first token.
  5. cli      - ``main.main([... --model llama3-8b --generate ...])``.

``--four-cards`` runs only the tensor-parallel check on four cards:
llama3-8b tp=4 against tp=1 on the same weights, and llama3-70b tp=4 cached
decode against an uncached forward. ``--rehearse`` runs the same phases on
the CPU at tiny widths, with the Pallas kernels in interpret mode and the
cuDNN call as XLA's implementation.

Any failure exits non-zero. The last line of standard output is one JSON
object: {"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.

    python chip_smoke.py [--four-cards] [--rehearse] [--seed N]
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Random-weight logits have a standard deviation near 1. The bf16 path
# rounds weights, activations and the residual stream to bf16 (2^-9
# relative) at every layer; the float32 reference does not. Bound on
# |bf16 logit - f32 logit| over every checked entry:
LOGIT_TOL = 0.25
LOGIT_TOL_REASON = ("bf16 weights/activations/residual (2^-9 rel per op over "
                    "2 adds per layer) vs f32; random-weight logits std ~1")

FULL = dict(model="llama3-8b", batch=8, prompt=1024, new=128, steps_checked=(
    0, 1, 31, 63, 126), requests=16, req_len=(32, 2048), req_new=(64, 128),
    max_batch=8, tp_batch=4, tp_prompt=512, tp_new=8, big_model="llama3-70b",
    big_batch=2, big_prompt=256, big_new=32)
TINY = dict(model="llama-tiny", batch=2, prompt=24, new=8, steps_checked=(
    0, 3, 6), requests=5, req_len=(4, 40), req_new=(4, 8), max_batch=2,
    tp_batch=2, tp_prompt=16, tp_new=4, big_model="llama-tiny", big_batch=2,
    big_prompt=16, big_new=6)

# Decode attention for generate, the engine and the CLI: "flash" selects
# the Pallas-Triton paged decode kernel and cuDNN prefill (PERF.md has the
# measurements that chose it over the plain XLA path).
ATTENTION = "flash"


class Fail(RuntimeError):
    pass


def card_lines(rehearse: bool):
    """Card name and power limit from nvidia-smi, in a child process that
    does not use JAX."""
    if rehearse:
        return ["cpu rehearsal, no card"]
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


class Log:
    def __init__(self, card: str):
        self.card = card

    def __call__(self, phase: str, msg: str) -> None:
        print(f"[{phase}] [{self.card}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Fail(what)


# ---------------------------------------------------------------------------
# shared pieces


def decode_path_logits(spec, impl, prompt_len: int, steps):
    """jit fn(params, ids [B, S+T]) -> logits [len(steps), B, V] from the
    cached decode path: prefill ids[:, :S], then feed ids[:, S+j] one token
    at a time (the step generate runs), keeping the logits after feeding
    token S+j for j in ``steps``."""
    import jax
    import jax.numpy as jnp

    from mlio_tpu.models import forward
    from mlio_tpu.runtime import init_cache

    idx = jnp.asarray(steps, jnp.int32)

    @jax.jit
    def fn(params, ids):
        B, L = ids.shape
        cache = init_cache(spec, B, L, dtype=params["tok_embed"].dtype)
        _, cache = forward(params, spec, ids[:, :prompt_len], impl=impl,
                           cache=cache)

        def step(cache, tok):
            logits, cache = forward(params, spec, tok[:, None], impl=impl,
                                    cache=cache)
            return cache, logits[:, 0]

        _, logits = jax.lax.scan(step, cache, ids[:, prompt_len:].T)
        return logits[idx]

    return fn


def reference_logits(spec):
    """jit fn(params, ids [b, L], pos [b, P]) -> float32 logits [b, P, V]
    at positions ``pos``: a cache-free forward with every layer's bf16
    weights cast to float32 inside the layer scan (exact), under the
    highest matmul precision."""
    import jax
    import jax.numpy as jnp

    from mlio_tpu import ops
    from mlio_tpu.models import Impl
    from mlio_tpu.models.transformer import (lm_logits, rope_cos_sin,
                                             run_layer_stack)

    f32 = jnp.float32

    @jax.jit
    def fn(params, ids, pos):
        up = lambda w: None if w is None else w.astype(f32)
        B, L = ids.shape
        x = up(params["tok_embed"])[ids]
        if spec.embed_scale is not None:
            x = x * spec.embed_scale
        positions = jnp.broadcast_to(jnp.arange(L)[None], (B, L))
        cos = sin = None
        if spec.positional == "learned":
            x = x + up(params["pos_embed"])[positions]
        else:
            cos, sin = rope_cos_sin(positions, spec.rope_dim, spec.rope_theta)
        x = run_layer_stack(x, params["blocks"], spec, Impl(), cos, sin,
                            weight_dtype=f32)
        x = jnp.take_along_axis(x, pos[..., None], axis=1)
        x = ops.norm(x, up(params["final_scale"]), up(params["final_bias"]),
                     kind=spec.norm, eps=spec.norm_eps)
        head = {k: up(params[k]) for k in ("tok_embed", "lm_head",
                                           "lm_head_bias")}
        return lm_logits(head, spec, x)

    def call(params, ids, pos):
        with jax.default_matmul_precision("highest"):
            return fn(params, ids, pos)

    return call


def score_rows(ref, params, rows, positions, length, group):
    """Reference logits for variable-length ``rows`` (lists of ids) at
    ``positions`` (one list per row), ``group`` rows per call, padded to
    ``length``; returns a list of [P_i, V] numpy arrays."""
    import jax.numpy as jnp
    import numpy as np

    out = []
    for g in range(0, len(rows), group):
        chunk = rows[g:g + group]
        pchunk = positions[g:g + group]
        npos = max(len(p) for p in positions)
        ids = np.zeros((group, length), np.int32)
        pos = np.zeros((group, npos), np.int32)
        for i, (r, p) in enumerate(zip(chunk, pchunk)):
            ids[i, :len(r)] = r
            pos[i, :len(p)] = p
        logits = np.asarray(ref(params, jnp.asarray(ids), jnp.asarray(pos)))
        out += [logits[i, :len(p)] for i, p in enumerate(pchunk)]
    return out


def memory_line(compiled) -> str:
    mem = compiled.memory_analysis()
    if mem is None:
        return "memory_analysis unavailable"
    return (f"args={mem.argument_size_in_bytes / 1e9:.3f} GB "
            f"out={mem.output_size_in_bytes / 1e9:.3f} GB "
            f"temp={mem.temp_size_in_bytes / 1e9:.3f} GB")


# ---------------------------------------------------------------------------
# phases


def phase_kernels(log, rehearse: bool) -> None:
    import jax.numpy as jnp

    from mlio_tpu.ops import validation as V

    if rehearse:
        runs = [
            lambda: V.validate_flash_attention(interpret=True),
            lambda: V.validate_flash_attention(q_offset=32, interpret=True),
            lambda: V.validate_paged_attention(interpret=True),
            lambda: V.validate_paged_attention(dtype=jnp.bfloat16,
                                               interpret=True),
            lambda: V.validate_decode_attention(interpret=True),
            lambda: V.validate_decode_attention(kv_int8=True, interpret=True),
            lambda: V.validate_ring_attention(),
            lambda: V.validate_quant_linear(fmt="int8"),
            lambda: V.validate_quant_linear(fmt="int4"),
            lambda: V.validate_moe(),
        ]
    else:
        # Llama-3-8B attention widths: 32 query heads, 8 KV heads, dim 128
        att = dict(heads=32, kv_heads=8, head_dim=128)
        runs = [
            lambda: V.validate_flash_attention(batch=8, seq=1024, **att),
            lambda: V.validate_flash_attention(batch=8, seq=1024,
                                               q_offset=128, **att),
            lambda: V.validate_paged_attention(
                batch=8, block_size=16, ctx=4000, max_blocks=256,
                dtype=jnp.float32, **att),
            lambda: V.validate_paged_attention(
                batch=8, block_size=16, ctx=4000, max_blocks=256,
                dtype=jnp.bfloat16, **att),
            lambda: V.validate_decode_attention(
                batch=8, smax=4096, ctx=4000, dtype=jnp.float32, **att),
            lambda: V.validate_decode_attention(
                batch=8, smax=4096, ctx=4000, dtype=jnp.bfloat16, **att),
            lambda: V.validate_decode_attention(
                batch=8, smax=4096, ctx=4000, kv_int8=True,
                dtype=jnp.bfloat16, **att),
            lambda: V.validate_ring_attention(batch=1, seq=4096, heads=32,
                                              head_dim=128, chunk=512),
            lambda: V.validate_quant_linear(m=64, k=4096, n=14336,
                                            fmt="int8"),
            lambda: V.validate_quant_linear(m=64, k=4096, n=14336,
                                            fmt="int4"),
            lambda: V.validate_moe(tokens=256, hidden=4096,
                                   intermediate=14336, experts=8, top_k=2),
        ]
    for run in runs:
        r = run()
        extra = {k: v for k, v in r.items()
                 if k not in ("kernel", "max_abs_diff", "tol", "reason",
                              "passed", "dtype")}
        log("kernels", f"{r['kernel']} dtype={r['dtype']} "
                       f"max_abs_err={r['max_abs_diff']:.3e} tol={r['tol']} "
                       f"({r['reason']}) {json.dumps(extra)}")
        check(r["passed"], f"kernel {r['kernel']} error {r['max_abs_diff']} "
                           f">= {r['tol']}")


def phase_generate(log, cfg, spec, params, impl, seed: int) -> None:
    import jax.numpy as jnp
    import numpy as np

    from mlio_tpu.runtime import generate

    B, S, T = cfg["batch"], cfg["prompt"], cfg["new"]
    rs = np.random.default_rng(seed)
    prompts = jnp.asarray(rs.integers(0, spec.vocab_size, (B, S)), jnp.int32)
    kw = dict(impl=impl, cache_len=S + T)

    t0 = time.perf_counter()
    out = generate(params, spec, prompts, max_new_tokens=T, **kw)
    out.block_until_ready()
    log("generate", f"first call (compile + run) {time.perf_counter() - t0:.2f} s")
    generate(params, spec, prompts, max_new_tokens=1, **kw).block_until_ready()
    t0 = time.perf_counter()
    out = generate(params, spec, prompts, max_new_tokens=T, **kw)
    out.block_until_ready()
    t_all = time.perf_counter() - t0
    t0 = time.perf_counter()
    generate(params, spec, prompts, max_new_tokens=1, **kw).block_until_ready()
    t_prefill = time.perf_counter() - t0
    step = (t_all - t_prefill) / (T - 1)
    check(out.shape == (B, S + T), f"generate shape {out.shape}")
    log("generate", f"B={B} prompt={S} new={T}: total {t_all:.4f} s, "
                    f"prefill {t_prefill:.4f} s, decode step "
                    f"{step * 1e3:.3f} ms, {B / step:.1f} tok/s")

    steps = cfg["steps_checked"]
    fn = decode_path_logits(spec, impl, S, steps)
    compiled = fn.lower(params, out).compile()
    log("generate", f"decode-path memory: {memory_line(compiled)}")
    dec = np.asarray(compiled(params, out), np.float32)       # [n, B, V]
    ref = reference_logits(spec)
    rows = [list(np.asarray(out[b])) for b in range(B)]
    pos = [[S + j for j in steps]] * B
    refs = score_rows(ref, params, rows, pos, S + T, min(4, B))
    err = max(float(np.abs(dec[:, b] - refs[b]).max()) for b in range(B))
    scale = max(float(np.abs(r).max()) for r in refs)
    log("generate", f"decode-path logits vs f32 re-scoring at steps "
                    f"{list(steps)}: max_abs_err={err:.4f} "
                    f"(max |logit| {scale:.2f}) tol={LOGIT_TOL} "
                    f"({LOGIT_TOL_REASON})")
    check(np.isfinite(dec).all(), "non-finite decode logits")
    check(err < LOGIT_TOL, f"generate logits error {err} >= {LOGIT_TOL}")


def phase_engine(log, cfg, spec, params, impl, seed: int) -> None:
    import numpy as np

    from mlio_tpu.runtime.engine import InferenceEngine

    rs = np.random.default_rng(seed + 1)
    n = cfg["requests"]
    lens = rs.integers(cfg["req_len"][0], cfg["req_len"][1] + 1, n)
    news = [int(x) for x in rs.integers(cfg["req_new"][0],
                                        cfg["req_new"][1] + 1, n)]
    prompts = [list(rs.integers(0, spec.vocab_size, int(m))) for m in lens]
    max_seq = cfg["req_len"][1] + cfg["req_new"][1]

    def make():
        return InferenceEngine(spec, params, max_batch=cfg["max_batch"],
                               max_seq_len=max_seq, impl=impl)

    t0 = time.perf_counter()
    make().run(prompts, news)
    log("engine", f"warm-up run (compiles) {time.perf_counter() - t0:.2f} s")
    eng = make()
    t0 = time.perf_counter()
    outs = eng.run(prompts, news)
    wall = time.perf_counter() - t0
    done = {r.req_id: r for r in eng.finished}
    check(len(done) == n, f"{len(done)} of {n} requests finished")
    for i, (o, want) in enumerate(zip(outs, news)):
        check(len(o) == want, f"request {i}: {len(o)} tokens, wanted {want}")
    ttft = sorted(r.first_token_at - r.submitted_at for r in done.values())
    total = sum(news)
    log("engine", f"{n} requests, prompts {int(lens.min())}-{int(lens.max())}"
                  f" tokens, {total} new tokens, max_batch="
                  f"{cfg['max_batch']}, scheduler={eng.sched.name}: "
                  f"{wall:.3f} s, {total / wall:.1f} "
                  f"tok/s, TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms "
                  f"max {ttft[-1] * 1e3:.1f} ms")

    ref = reference_logits(spec)
    rows = [p + o for p, o in zip(prompts, outs)]
    pos = [[len(p) - 1 + j for j in range(len(o))]
           for p, o in zip(prompts, outs)]
    refs = score_rows(ref, params, rows, pos, max_seq, min(4, n))
    worst = 0.0
    for o, r in zip(outs, refs):
        gap = r.max(axis=-1) - r[np.arange(len(o)), np.asarray(o)]
        worst = max(worst, float(gap.max()))
    log("engine", f"greedy tokens vs f32 re-scoring: max(row max - token "
                  f"logit)={worst:.4f} over {total} tokens tol={LOGIT_TOL} "
                  f"({LOGIT_TOL_REASON})")
    check(worst < LOGIT_TOL, f"engine token gap {worst} >= {LOGIT_TOL}")


def phase_cli(log, cfg, out_dir: Path, rehearse: bool) -> None:
    sys.path.insert(0, str(REPO))
    import main as cli

    # the CLI has no interpret switch: a rehearsal takes the plain path
    argv = ["--model", cfg["model"], "--generate", "1 2 3 4 5 6 7 8",
            "--max-new-tokens", "8",
            "--attention", "dense" if rehearse else ATTENTION,
            "--output-dir", str(out_dir)]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    gen = [ln for ln in text.splitlines() if ln.startswith("generated:")]
    check(rc == 0, f"CLI returned {rc}")
    check(len(gen) == 1 and len(json.loads(gen[0].split(":", 1)[1])) == 8,
          f"CLI output {gen}")
    check((out_dir / "used_config.json").exists(), "CLI wrote no config")
    log("cli", f"main.main({' '.join(argv)}) rc={rc} in {wall:.1f} s: "
               f"{gen[0]}")


def phase_four_cards(log, cfg, seed: int, rehearse: bool) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mlio_tpu.models import Impl, forward, get_spec
    from mlio_tpu.parallel import make_mesh, shard_params
    from mlio_tpu.parallel.tensor_parallel import init_sharded_params

    check(jax.device_count() >= 4, f"{jax.device_count()} devices, need 4")
    mesh = make_mesh(tensor=4, devices=jax.devices()[:4])
    impl = Impl()
    rs = np.random.default_rng(seed + 2)

    # (a) the same weights at tp=1 and tp=4
    spec = get_spec(cfg["model"])
    B, S, T = cfg["tp_batch"], cfg["tp_prompt"], cfg["tp_new"]
    ids = jnp.asarray(rs.integers(0, spec.vocab_size, (B, S + T)), jnp.int32)
    steps = tuple(range(T))
    fn = decode_path_logits(spec, impl, S, steps)
    p1 = init_sharded_params(spec, jax.random.PRNGKey(seed), jnp.bfloat16)
    t0 = time.perf_counter()
    l1 = np.asarray(fn(p1, ids), np.float32)
    t1 = time.perf_counter() - t0
    p4 = shard_params(p1, spec, mesh)
    del p1
    t0 = time.perf_counter()
    l4 = np.asarray(fn(p4, ids), np.float32)
    t4 = time.perf_counter() - t0
    del p4
    err = float(np.abs(l1 - l4).max())
    log("four-cards", f"{spec.name} tp=4 vs tp=1, B={B} prefill {S} + {T} "
                      f"decode steps: max_abs_err={err:.4f} tol={LOGIT_TOL} "
                      f"(same bf16 weights; TP changes summation order); "
                      f"first calls {t1:.1f} s / {t4:.1f} s")
    check(np.isfinite(l4).all() and err < LOGIT_TOL,
          f"tp=4 vs tp=1 error {err}")

    # (b) a model that needs the four cards: cached decode vs re-forward
    spec = get_spec(cfg["big_model"])
    B, S, T = cfg["big_batch"], cfg["big_prompt"], cfg["big_new"]
    ids = jnp.asarray(rs.integers(0, spec.vocab_size, (B, S + T)), jnp.int32)
    t0 = time.perf_counter()
    params = init_sharded_params(spec, jax.random.PRNGKey(seed), jnp.bfloat16,
                                 mesh)
    jax.block_until_ready(params)
    per_card = [d.memory_stats() or {} for d in jax.devices()[:4]]
    log("four-cards", f"{spec.name} params created sharded in "
                      f"{time.perf_counter() - t0:.1f} s; bytes in use per "
                      f"card: {[s.get('bytes_in_use') for s in per_card]}")
    steps = tuple(range(T))
    cached = np.asarray(decode_path_logits(spec, impl, S, steps)(params, ids),
                        np.float32)                         # [T, B, V]

    @jax.jit
    def uncached(params, ids):
        logits, _ = forward(params, spec, ids, impl=impl)
        return logits[:, S:S + T]

    full = np.asarray(uncached(params, ids), np.float32).transpose(1, 0, 2)
    err = float(np.abs(cached - full).max())
    log("four-cards", f"{spec.name} tp=4, B={B} prefill {S} + {T} decode "
                      f"steps: cached vs uncached max_abs_err={err:.4f} "
                      f"tol={LOGIT_TOL} (both bf16; cache written in bf16)")
    check(np.isfinite(cached).all() and err < LOGIT_TOL,
          f"70B cached vs uncached error {err}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card tensor-parallel check")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU, tiny widths, kernels in interpret mode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=str(REPO / "chiprun_out"
                                             / "chip_smoke"))
    args = ap.parse_args(argv)
    cfg = TINY if args.rehearse else FULL
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four_cards:
            os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                                       "--xla_force_host_platform_device_"
                                       "count=4").strip()
    sys.path.insert(0, str(REPO))

    import jax

    from mlio_tpu.utils.device_utils import enable_compile_cache

    dev = jax.devices()[0]
    want = "cpu" if args.rehearse else "gpu"
    if dev.platform != want:
        print(f"chip_smoke: platform is {dev.platform!r}, need {want!r}",
              file=sys.stderr)
        return 2
    cards = card_lines(args.rehearse)
    card = cards[0] if len(cards) == 1 else f"{len(cards)} x {cards[0]}"
    log = Log(card)
    for line in cards:
        log("device", f"nvidia-smi name, power.limit: {line}")
    log("device", f"jax {jax.__version__}: {jax.device_count()} x "
                  f"{dev.device_kind} ({dev.platform})")
    log("device", f"compile cache: {enable_compile_cache()}")

    if args.four_cards:
        phase_four_cards(log, cfg, args.seed, args.rehearse)
    else:
        import jax.numpy as jnp

        from mlio_tpu.models import Impl, load_model

        impl = Impl(attention=ATTENTION, interpret=args.rehearse)
        phase_kernels(log, args.rehearse)
        t0 = time.perf_counter()
        spec, params = load_model(cfg["model"], dtype=jnp.bfloat16,
                                  seed=args.seed)
        jax.block_until_ready(params)
        log("generate", f"{spec.name}: {spec.num_params() / 1e9:.2f} B "
                        f"params, bf16, random from seed {args.seed}, "
                        f"created in {time.perf_counter() - t0:.1f} s")
        phase_generate(log, cfg, spec, params, impl, args.seed)
        phase_engine(log, cfg, spec, params, impl, args.seed)
        del params
        phase_cli(log, cfg, Path(args.out_dir) / "cli", args.rehearse)

    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": jax.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
