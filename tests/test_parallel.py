"""Parallelism integration tests on the real 8-device CPU mesh.

Rebuild of the reference's ParallelismTestSuite intent
(/root/reference/test_parallelism.py:83-725): TP / PP / DP / combined plans
must produce logits matching the single-device reference (the reference's
tolerance is 0.1 for fp16 multi-GPU, test_parallelism.py:322; fp32 on CPU
lets us demand far tighter agreement), running REAL collectives instead of
the reference's SimulatedDistributedEnv monkeypatches (:806-886).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mlio_tpu.models import Impl, forward, get_spec, init_params
from mlio_tpu.parallel import make_mesh, shard_params
from mlio_tpu.parallel.auto_config import (
    AutoParallelConfig,
    CandidatePlan,
    HardwareSpec,
    ParallelismCostModel,
)
from mlio_tpu.parallel.collectives import estimate_collective_time
from mlio_tpu.parallel.orchestrator import ParallelOrchestrator, ParallelPlan


@pytest.fixture(scope="module")
def model():
    spec = get_spec("llama-tiny")
    params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    ids = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0,
                             spec.vocab_size)
    ref, _ = forward(params, spec, ids)
    return spec, params, ids, np.asarray(ref)


@pytest.mark.parametrize("plan", [
    ParallelPlan(tensor=2, data=4),
    ParallelPlan(tensor=2, data=2, sequence=2),
    ParallelPlan(data=8),
], ids=["tp2dp4", "tp2dp2sp2", "dp8"])
def test_gspmd_plans_match_reference(model, plan):
    spec, params, ids, ref = model
    orch = ParallelOrchestrator(plan, spec)
    sharded = orch.shard_params(params)
    ids_s = orch.shard_inputs(ids)
    fn = orch.forward_fn()
    with orch.mesh:
        out = fn(sharded, ids_s)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("pp,micro", [(2, 2), (2, 4), (4, 4)])
def test_pipeline_matches_reference(model, pp, micro):
    spec, params, ids, ref = model
    if spec.num_layers % pp:
        pytest.skip("layers must divide stages")
    plan = ParallelPlan(pipeline=pp, microbatches=micro)
    orch = ParallelOrchestrator(plan, spec)
    sharded = orch.shard_params(params)
    fn = orch.forward_fn()
    with orch.mesh:
        out = fn(sharded, ids)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-4, atol=2e-4)


def test_pipeline_with_tensor_parallel(model):
    spec, params, ids, ref = model
    plan = ParallelPlan(pipeline=2, tensor=2, data=2)
    orch = ParallelOrchestrator(plan, spec)
    sharded = orch.shard_params(params)
    fn = orch.forward_fn()
    with orch.mesh:
        out = fn(sharded, orch.shard_inputs(ids))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-4, atol=2e-4)


def test_plan_validation(model):
    spec, *_ = model
    with pytest.raises(ValueError):
        ParallelPlan(tensor=16).validate(spec, 8)  # too many devices
    with pytest.raises(ValueError):
        ParallelPlan(pipeline=3).validate(spec, 8)  # 2 layers % 3 != 0
    with pytest.raises(Exception):
        ParallelPlan(tensor=3).validate(spec, 8)  # heads % 3 != 0


def test_orchestrator_estimates(model):
    spec, *_ = model
    orch = ParallelOrchestrator(ParallelPlan(tensor=2, data=4), spec)
    mem = orch.memory_usage_estimate(batch=4, seq_len=64)
    assert mem["fits"] and mem["bytes_per_chip"] > 0
    thr = orch.throughput_estimate(batch=4, seq_len=64)
    assert thr["tokens_per_sec"] > 0
    assert 0 <= thr["comm_fraction"] < 1


def test_auto_config_search():
    spec = get_spec("llama2-70b")
    hw = HardwareSpec(kind="NVIDIA H100 80GB HBM3", num_chips=8)
    auto = AutoParallelConfig(spec, hw=hw)
    req = auto.model_requirements(batch=8, seq_len=2048)
    assert not req["fits_single_chip"]  # 70B bf16 > 80GB HBM
    plans = auto.search(batch=8, seq_len=2048)
    assert plans and plans[0][1] < float("inf")
    best = auto.best_plan(batch=8, seq_len=2048)
    assert best.world <= 8
    assert best.tp > 1  # 70B needs sharding to fit

    # cost model sanity: more TP -> less memory per chip
    model = ParallelismCostModel(spec, hw)
    m1 = model.memory_per_chip(CandidatePlan(tp=1), 8, 2048)
    m8 = model.memory_per_chip(CandidatePlan(tp=8), 8, 2048)
    assert m8 < m1 / 4


def test_collective_time_model():
    t_ar = estimate_collective_time(1 << 20, 8, collective="all_reduce")
    t_ag = estimate_collective_time(1 << 20, 8, collective="all_gather")
    assert t_ar > t_ag > 0
    assert estimate_collective_time(1 << 20, 1) == 0.0


def test_collectives_inside_shard_map():
    """all_reduce/all_gather/reduce_scatter/broadcast/ring_exchange run for
    real over the mesh (the reference never tests its comm primitives —
    SURVEY.md §4 gap)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mlio_tpu.parallel import collectives as C

    mesh = make_mesh(data=8)
    x = jnp.arange(16, dtype=jnp.float32).reshape(8, 2)
    xs = jax.device_put(x, NamedSharding(mesh, P("data", None)))

    def body(x):
        s = C.all_reduce(x, "data")
        m = C.all_reduce(x, "data", op="avg")
        g = C.all_gather(x, "data", dim=0)
        rs = C.reduce_scatter(g, "data", dim=0)
        b = C.broadcast(x, "data", root=3)
        r = C.ring_exchange(x, axis="data")
        return s, m, g, rs, b, r

    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=P("data", None),
                       out_specs=(P("data", None), P("data", None), P(None),
                                  P("data", None), P("data", None),
                                  P("data", None)),
                       check_vma=False)
    s, m, g, rs, b, r = fn(xs)
    np.testing.assert_allclose(np.asarray(s)[0], x.sum(0))
    np.testing.assert_allclose(np.asarray(m)[0], x.mean(0))
    np.testing.assert_allclose(np.asarray(g), x)
    np.testing.assert_allclose(np.asarray(rs), x * 8)  # sum of 8 copies, scattered
    np.testing.assert_allclose(np.asarray(b), np.tile(x[3], (8, 1)))
    np.testing.assert_allclose(np.asarray(r), np.roll(x, 1, axis=0))


# -- quantized weights under TP (BASELINE config 5: FP8 sharded serving) -----

@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantized_tp_matches_unsharded(model, fmt):
    """QTensor leaves shard like dense weights: payload on the weight's
    PartitionSpec, per-output-channel scale following the output dim.
    (Reference shards quantized layers by module surgery,
    tensor_parallel.py:88-330.)"""
    from mlio_tpu.runtime.quantization import quantize_params

    spec, params, ids, _ = model
    qparams = quantize_params(params, spec, fmt)
    ref, _ = forward(qparams, spec, ids)

    mesh = make_mesh(data=4, tensor=2)
    sharded = shard_params(qparams, spec, mesh)
    with mesh:
        out, _ = jax.jit(lambda p, i: forward(p, spec, i)[0:2])(sharded, ids)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


def test_fp8_sharded_continuous_batching():
    """Config-5 mechanics at test scale: FP8 weight-only quantized model,
    tensor-sharded over a mesh, served by the continuous-batching engine
    (70B-class deployment = same code path at bigger shapes)."""
    from mlio_tpu.runtime.engine import InferenceEngine
    from mlio_tpu.runtime.quantization import quantize_params

    spec = get_spec("llama-tiny")
    params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    qparams = quantize_params(params, spec, "fp8")
    mesh = make_mesh(data=4, tensor=2)
    sharded = shard_params(qparams, spec, mesh)

    with mesh:
        eng = InferenceEngine(spec, sharded, max_batch=4, max_seq_len=64,
                              dtype=jnp.float32)
        prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
        outs = eng.run(prompts, max_new_tokens=5)
    assert len(outs) == 3
    for o in outs:  # outputs are the GENERATED tokens only
        assert len(o) == 5
        assert all(0 <= t < spec.vocab_size for t in o)


# ---------------------------------------------------------------------------
# Runtime-adaptive executor (parity: RuntimeAdaptiveExecutor
# orchestrator.py:421-483)


def test_adaptive_executor_replans_under_pressure(model):
    from mlio_tpu.parallel import AdaptiveExecutor, RuntimeMonitor

    spec, params, ids, ref = model
    # start on a deliberately memory-heavy plan (no tensor sharding)
    orch = ParallelOrchestrator(ParallelPlan(data=1), spec,
                                hw=HardwareSpec(num_chips=8))
    # fake monitor: always report 99% HBM occupancy
    mon = RuntimeMonitor(stats_fn=lambda: {"fraction": 0.99})
    ex = AdaptiveExecutor(orch, memory_threshold=0.9, patience=2,
                          monitor=mon)
    sharded = orch.shard_params(params)
    before = ex.orch.plan
    out = None
    for _ in range(3):
        out = ex.step(sharded, orch.shard_inputs(ids))
    assert ex.adaptations, "sustained pressure must trigger a re-plan"
    assert ex.adaptations[0]["reason"] == "pressure"
    assert ex.adaptations[0]["bytes_after"] < ex.adaptations[0]["bytes_before"]
    assert ex.orch.plan != before
    # pre-adaptation outputs still match the dense reference
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-4, atol=2e-4)


def test_adaptive_executor_steady_state_keeps_plan(model):
    from mlio_tpu.parallel import AdaptiveExecutor, RuntimeMonitor

    spec, params, ids, ref = model
    orch = ParallelOrchestrator(ParallelPlan(tensor=2, data=4), spec,
                                hw=HardwareSpec(num_chips=8))
    mon = RuntimeMonitor(stats_fn=lambda: {"fraction": 0.2})
    ex = AdaptiveExecutor(orch, monitor=mon)
    sharded = orch.shard_params(params)
    x = orch.shard_inputs(ids)
    for _ in range(4):
        out = ex.step(sharded, x)
    assert not ex.adaptations
    assert ex.monitor.memory_pressure == pytest.approx(0.2)
    assert ex.monitor.throughput_trend > 0
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-4, atol=2e-4)


def test_ring_cross_attention_matches_dense():
    from mlio_tpu.ops.reference import attention_reference
    from mlio_tpu.ops.ring_attention import ring_cross_attention

    ks = jax.random.split(jax.random.PRNGKey(7), 3)
    q = jax.random.normal(ks[0], (2, 48, 4, 32), jnp.float32)
    k = jax.random.normal(ks[1], (2, 200, 4, 32), jnp.float32)
    v = jax.random.normal(ks[2], (2, 200, 4, 32), jnp.float32)
    out = ring_cross_attention(q, k, v, chunk_size=64)
    ref = attention_reference(q, k, v, causal=False)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_gather_sequence_stays_on_device():
    """gather_sequence is a mesh all-gather, not a host fetch (r1 weak #9)."""
    from mlio_tpu.parallel import gather_sequence, make_mesh, scatter_sequence

    mesh = make_mesh(seq=4)
    x = jnp.arange(4 * 8 * 16, dtype=jnp.float32).reshape(4, 8, 16)
    xs = scatter_sequence(x, mesh, dim=1)
    g = gather_sequence(xs)
    assert isinstance(g, jax.Array)  # device array, not numpy
    assert g.sharding.is_fully_replicated
    np.testing.assert_array_equal(np.asarray(g), np.asarray(x))
