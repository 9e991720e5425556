"""Benchmark runner / metrics / reporting / scenario tests
(parity: the reference's validation behavior runners.py:250-297 and
metrics.py:211-320)."""
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mlio_tpu.benchmarks import (
    BenchmarkConfig,
    BenchmarkReport,
    BenchmarkRunner,
    MemoryBenchmark,
    ReportGenerator,
    ScalingBenchmark,
    ThroughputBenchmark,
    metrics,
)
from mlio_tpu.models import Impl, get_spec, init_params


@pytest.fixture(scope="module")
def model():
    spec = get_spec("gpt2-tiny")
    params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    return spec, params


def test_metrics_functions():
    assert metrics.speedup(2.0, 1.0) == 2.0
    assert metrics.memory_reduction(100, 25) == 0.75
    assert metrics.scaling_efficiency(8.0, 1.25, 8) == pytest.approx(0.8)
    assert metrics.communication_overhead(1.0, 0.7) == pytest.approx(0.3)
    lp = metrics.latency_percentiles([0.01] * 10)
    assert lp["p99_ms"] == pytest.approx(10.0)
    assert metrics.relative_error([1.0, 2.0], [1.0, 2.002]) < 2e-3
    st = metrics.check_numerical_stability(np.array([1.0, np.inf]))
    assert st["has_inf"] and not st["stable"]


def test_determinism_check(model):
    spec, params = model
    ids = jnp.zeros((1, 8), jnp.int32)
    from mlio_tpu.models.transformer import forward

    fn = jax.jit(lambda: forward(params, spec, ids)[0])
    assert metrics.verify_determinism(fn, runs=3)


def test_perplexity_delta_int8_gate(model):
    """INT8 weight-only must hold a small ppl delta (the BASELINE gate,
    scaled to a tiny random model: delta bound is loose but nonzero)."""
    spec, params = model
    from mlio_tpu.runtime import quantize_params

    qparams = quantize_params(params, spec, "int8")
    ids = jax.random.randint(jax.random.PRNGKey(1), (2, 33), 0,
                             spec.vocab_size)
    res = metrics.perplexity_delta(params, qparams, spec, ids)
    assert res["ppl_a"] > 0
    assert abs(res["delta"]) < 0.1 * res["ppl_a"] + 0.5


def test_runner_sweep_validates_variants(model, tmp_path):
    spec, params = model
    cfg = BenchmarkConfig(batch_sizes=[1], seq_lens=[16], warmup_iters=1,
                          iters=2, output_dir=str(tmp_path))
    runner = BenchmarkRunner(cfg, variants={
        "baseline": Impl(),
        "flash_attention": Impl(attention="flash", interpret=True)})
    results = runner.run_model_sweep(spec, params)
    assert len(results) == 2
    fa = [r for r in results if r["variant"] == "flash_attention"][0]
    assert fa["validated"], fa.get("max_abs_error")
    path = runner.save_results()
    data = json.loads(open(path).read())
    assert data["results"]


def test_throughput_and_memory_benchmarks(model):
    spec, params = model
    cfg = BenchmarkConfig(warmup_iters=1, iters=2)
    tb = ThroughputBenchmark(cfg)
    r = tb.run_decode(spec, params, batch=2, prompt_len=4, new_tokens=4,
                      cache_len=16)
    assert r["tokens_per_sec"] > 0
    mb = MemoryBenchmark(cfg)
    m = mb.run_memory(spec, params)
    assert m["param_bytes"] > 0 and 0 < m["memory_efficiency"] <= 1


def test_scaling_benchmark_over_mesh(model):
    spec, params = model
    cfg = BenchmarkConfig(warmup_iters=1, iters=2)
    sb = ScalingBenchmark(cfg)
    r = sb.run_scaling(spec, params, batch=8, seq_len=16)
    assert r["num_devices"] == 8
    assert r["scaling_efficiency"] > 0


def test_report_generation(model, tmp_path):
    spec, params = model
    cfg = BenchmarkConfig(batch_sizes=[1], seq_lens=[16], warmup_iters=1,
                          iters=2, output_dir=str(tmp_path))
    runner = BenchmarkRunner(cfg, variants={
        "baseline": Impl(),
        "flash_attention": Impl(attention="flash", interpret=True)})
    runner.run_model_sweep(spec, params)
    runner.save_results()

    rep = BenchmarkReport(runner.results, name="test")
    assert "speedup" in rep.comparison_table().columns
    md = rep.to_markdown(tmp_path / "r.md")
    assert "Benchmark report" in md
    rep.to_html(tmp_path / "r.html")
    rep.to_json(tmp_path / "r.json")
    pngs = rep.plot(tmp_path)
    assert pngs and (tmp_path / pngs[0].split("/")[-1]).exists()

    gen = ReportGenerator(str(tmp_path))
    text = gen.optimization_report()
    assert "Optimization report" in text
    assert "result sets" in gen.generate_readme()


def test_latency_scenarios(model):
    from mlio_tpu.benchmarks.scenarios import (
        first_token_latency_test,
        latency_under_load,
        standard_latency_test,
    )

    spec, params = model
    r = standard_latency_test(spec, params, seq_len=16, iters=3)
    assert r["p99_ms"] > 0
    r2 = latency_under_load(spec, params, seq_len=16, num_requests=6,
                            num_workers=2)
    assert r2["requests_per_sec"] > 0 and len(r2) > 4
    r3 = first_token_latency_test(spec, params, prompt_len=16, iters=2)
    assert r3["mean_ms"] > 0


def test_offered_load_sweep(model):
    """Open-loop arrival-rate sweep: every rate reports achieved rps +
    latency percentiles with queueing delay included."""
    from mlio_tpu.benchmarks.scenarios import latency_under_offered_load

    spec, params = model
    r = latency_under_offered_load(spec, params, seq_len=16,
                                   arrival_rates=(20.0, 100.0),
                                   duration_s=0.3, num_workers=2)
    assert [s["offered_rps"] for s in r["sweep"]] == [20.0, 100.0]
    for s in r["sweep"]:
        assert s["achieved_rps"] > 0 and s["p99_ms"] >= s["p50_ms"] > 0


def test_throughput_scenarios(model):
    from mlio_tpu.benchmarks.scenarios import (
        batch_scaling_test,
        mixed_precision_sweep,
        multi_device_throughput_test,
    )

    spec, params = model
    rs = batch_scaling_test(spec, params, batch_sizes=(1, 2), seq_len=16)
    assert len(rs) == 2
    r = multi_device_throughput_test(spec, params, batch=1, seq_len=16)
    assert r["num_devices"] == 8
    sweep = mixed_precision_sweep(spec, params, batch=1, seq_len=16)
    assert {s["precision"] for s in sweep} == {"fp32", "bf16", "int8-weights"}
