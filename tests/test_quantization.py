"""Quantization tests: quantizers, quantized matmul, end-to-end model
accuracy (parity intent: the reference's int8/int4 paths
baseline/inference.py:467-557 and its quantization-stats reporting)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mlio_tpu.ops.quant import (
    QTensor,
    dequantize,
    linear,
    quantize,
    quantize_int4,
    quantize_int8,
    unpack_int4,
)
from mlio_tpu.models import get_spec, init_params
from mlio_tpu.runtime import quantize_params, quantized_size_bytes


def test_int8_roundtrip_error():
    w = jax.random.normal(jax.random.PRNGKey(0), (64, 96))
    t = quantize_int8(w)
    assert t.q.dtype == jnp.int8 and t.scale.shape == (96,)
    err = np.abs(np.asarray(dequantize(t)) - np.asarray(w))
    # worst-case quantization error is scale/2 per channel
    bound = np.asarray(t.scale) / 2 + 1e-6
    assert (err <= bound[None, :]).all()


def test_int4_pack_unpack_exact():
    w = jax.random.normal(jax.random.PRNGKey(1), (32, 48))
    # per-channel layout (group_size=None)
    t = quantize_int4(w, group_size=None)
    assert t.q.shape == (16, 48) and t.scale.shape == (48,)
    unpacked = np.asarray(unpack_int4(t.q))
    assert unpacked.min() >= -7 and unpacked.max() <= 7
    # re-deriving q from dequant must round-trip exactly
    q_direct = np.clip(np.round(np.asarray(w) / np.asarray(t.scale)), -7, 7)
    np.testing.assert_array_equal(unpacked, q_direct.astype(np.int8))
    # group-wise layout (the default): scale [K//g, N], rows of a group
    # share one scale per output channel
    tg = quantize_int4(w)
    g = 32 // tg.scale.shape[0]
    assert tg.scale.shape == (32 // g, 48)
    sc = np.repeat(np.asarray(tg.scale), g, axis=0)
    q_direct = np.clip(np.round(np.asarray(w) / sc), -7, 7)
    np.testing.assert_array_equal(np.asarray(unpack_int4(tg.q)),
                                  q_direct.astype(np.int8))


def test_int4_group_scales_beat_per_channel_on_outliers():
    """Group-wise int4 (the default) must track an outlier-heavy weight
    better than per-channel scales (VERDICT r3 #6: -4.7% rel ppl at 7B
    geometry with per-channel int4)."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(512, 128)).astype(np.float32)
    w[100:104, :] *= 25.0  # outlier rows inflate per-channel scales
    wj = jnp.asarray(w)
    err_pc = float(jnp.mean(jnp.abs(
        dequantize(quantize_int4(wj, group_size=None)) - wj)))
    err_g = float(jnp.mean(jnp.abs(dequantize(quantize_int4(wj)) - wj)))
    assert err_g < 0.5 * err_pc, (err_g, err_pc)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quant_matmul_matches_dequant(fmt):
    """linear() on a QTensor (dequant fused into the GEMM by XLA) == the
    explicitly dequantized product, at a prefill-sized M."""
    x = jax.random.normal(jax.random.PRNGKey(2), (50, 256))
    w = jax.random.normal(jax.random.PRNGKey(3), (256, 200)) * 0.1
    t = quantize(w, fmt)
    out = jax.jit(linear)(x, t)
    ref = x @ dequantize(t)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_fp8_linear():
    x = jax.random.normal(jax.random.PRNGKey(4), (10, 32))
    w = jax.random.normal(jax.random.PRNGKey(5), (32, 64)) * 0.1
    t = quantize(w, "fp8")
    out = linear(x, t)
    rel = np.abs(np.asarray(out - x @ w)).max() / np.abs(np.asarray(x @ w)).max()
    assert rel < 0.1  # fp8 e4m3 has ~2 decimal digits


def test_qtensor_is_pytree():
    t = quantize_int8(jnp.ones((8, 16)))
    leaves, treedef = jax.tree_util.tree_flatten(t)
    assert len(leaves) == 2  # q + scale; fmt is static aux data
    t2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert t2.fmt == "int8"
    # must survive jit
    f = jax.jit(lambda t, x: x @ dequantize(t))
    _ = f(t, jnp.ones((4, 8)))


@pytest.mark.parametrize("model_name", ["gpt2-tiny", "llama-tiny"])
def test_quantized_model_end_to_end(model_name):
    """INT8 weight-only model must track the fp32 model closely and shrink
    parameter bytes ~4x on the projection weights."""
    from mlio_tpu.models import forward, get_spec, init_params

    spec = get_spec(model_name)
    params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    qparams = quantize_params(params, spec, "int8")
    ids = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, spec.vocab_size)

    ref, _ = forward(params, spec, ids)
    out, _ = forward(qparams, spec, ids)
    ref, out = np.asarray(ref), np.asarray(out)
    # top-1 prediction agreement on random-init logits is a strong check
    # given int8 noise; also bound the absolute drift.
    assert np.abs(ref - out).max() < 0.15 * np.abs(ref).max() + 0.05
    assert quantized_size_bytes(qparams) < quantized_size_bytes(params)


def test_quantized_generation_runs():
    from mlio_tpu.models import get_spec, init_params
    from mlio_tpu.runtime import greedy_generate

    spec = get_spec("llama-tiny")
    params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    qparams = quantize_params(params, spec, "int8")
    ids = jnp.asarray([[1, 2, 3, 4]])
    out = greedy_generate(qparams, spec, ids, max_new_tokens=6)
    assert out.shape == (1, 10)


def test_int4_model_runs():
    from mlio_tpu.models import forward, get_spec, init_params

    spec = get_spec("llama-tiny")
    params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    qparams = quantize_params(params, spec, "int4")
    ids = jax.random.randint(jax.random.PRNGKey(1), (1, 8), 0, spec.vocab_size)
    out, _ = forward(qparams, spec, ids)
    assert np.isfinite(np.asarray(out)).all()


def test_init_quantized_params_runs_forward():
    """Direct random-quantized init (no fp staging) must produce a working
    pytree — the 7B single-chip benchmark path (bench_extra.py)."""
    import jax
    from mlio_tpu.models import get_spec, forward
    from mlio_tpu.runtime.quantization import init_quantized_params
    from mlio_tpu.ops.quant import QTensor

    spec = get_spec("llama-tiny")
    params = init_quantized_params(spec, jax.random.PRNGKey(0),
                                   dtype=jnp.float32)
    assert isinstance(params["blocks"]["wq"], QTensor)
    assert params["blocks"]["wq"].q.dtype == jnp.int8
    ids = jnp.zeros((2, 5), jnp.int32)
    logits, _ = forward(params, spec, ids)
    assert logits.shape == (2, 5, spec.vocab_size)
    assert bool(jnp.all(jnp.isfinite(logits)))


def test_fuse_projections_parity():
    """wqkv / w_upgate fusion: identical greedy outputs, plain and int8."""
    import numpy as np
    from mlio_tpu.models import Impl, get_spec, init_params
    from mlio_tpu.runtime import greedy_generate
    from mlio_tpu.runtime.quantization import (
        fuse_projections,
        quantize_params,
    )

    for name in ("gpt2-tiny", "llama-tiny"):
        spec = get_spec(name)
        params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
        ids = jnp.asarray([[5, 3, 2, 6], [1, 2, 3, 4]], jnp.int32)
        impl = Impl()
        base = greedy_generate(params, spec, ids, max_new_tokens=5, impl=impl)
        fused = fuse_projections(params, spec)
        assert "wq" not in fused["blocks"] and "wqkv" in fused["blocks"]
        out = greedy_generate(fused, spec, ids, max_new_tokens=5, impl=impl)
        assert np.array_equal(np.asarray(base), np.asarray(out)), name
        qbase = greedy_generate(quantize_params(params, spec, "int8"), spec,
                                ids, max_new_tokens=5, impl=impl)
        qfused = fuse_projections(quantize_params(params, spec, "int8"), spec)
        qout = greedy_generate(qfused, spec, ids, max_new_tokens=5, impl=impl)
        assert np.array_equal(np.asarray(qbase), np.asarray(qout)), name
        # the fused layout through the flash decode path agrees too
        auto = greedy_generate(fused, spec, ids, max_new_tokens=5,
                               impl=Impl(attention="flash", interpret=True))
        assert np.array_equal(np.asarray(base), np.asarray(auto)), name


# ---------------------------------------------------------------------------
# W8A8: single-pass calibration + static activation-quant matmul
# (VERDICT r1 missing #3 / weak #8)


def test_calibration_single_pass_per_layer_stats():
    from mlio_tpu.runtime.quantization import calibrate_activation_scales

    spec = get_spec("llama-tiny")
    params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    ids = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                             spec.vocab_size)
    stats = calibrate_activation_scales(params, spec, ids)
    for site in ("attn_in", "attn_out_in", "mlp_in", "mlp_down_in"):
        assert stats[site].shape == (spec.num_layers,)
        assert bool(jnp.all(stats[site] > 0))
    # multi-batch input takes the max over batches
    ids3 = jnp.stack([ids, ids * 0 + 1])
    stats3 = calibrate_activation_scales(params, spec, ids3)
    assert bool(jnp.all(stats3["attn_in"] >= 0))


def test_w8a8_forward_close_to_fp32():
    from mlio_tpu.models.transformer import forward
    from mlio_tpu.ops.quant import QTensor
    from mlio_tpu.runtime.quantization import (apply_activation_scales,
                                               calibrate_activation_scales,
                                               quantize_params)

    spec = get_spec("llama-tiny")
    params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    ids = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                             spec.vocab_size)
    ref_logits, _ = forward(params, spec, ids)

    stats = calibrate_activation_scales(params, spec, ids)
    qp = quantize_params(params, spec, "int8")
    w8a8 = apply_activation_scales(qp, stats)
    # act_scale attached per quantizable weight, one per layer
    for name in ("wq", "wo", "w_up", "w_down"):
        w = w8a8["blocks"][name]
        assert isinstance(w, QTensor) and w.act_scale is not None
        assert w.act_scale.shape == (spec.num_layers,)

    out_logits, _ = forward(w8a8, spec, ids)
    ref = np.asarray(ref_logits, np.float32)
    out = np.asarray(out_logits, np.float32)
    # W8A8 on random weights: logits track fp32 within quantization noise
    err = np.abs(out - ref).max() / (np.abs(ref).max() + 1e-6)
    assert err < 0.12, err
    # and W8A8 must differ from weight-only int8 (it actually quantizes acts)
    wonly_logits, _ = forward(qp, spec, ids)
    assert not np.allclose(out, np.asarray(wonly_logits), atol=1e-6)


def test_w8a8_perplexity_delta_gate():
    """ppl(W8A8) - ppl(fp32) stays small on a tiny model (the metric the
    BASELINE <=0.1 gate uses; benchmarks/metrics.py perplexity_delta)."""
    from mlio_tpu.benchmarks.metrics import perplexity
    from mlio_tpu.models.transformer import forward
    from mlio_tpu.runtime.quantization import (apply_activation_scales,
                                               calibrate_activation_scales,
                                               quantize_params)

    spec = get_spec("gpt2-tiny")
    params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    ids = jax.random.randint(jax.random.PRNGKey(2), (4, 32), 0,
                             spec.vocab_size)

    def ppl(p):
        logits, _ = forward(p, spec, ids)
        return perplexity(logits[:, :-1], ids[:, 1:])

    base = ppl(params)
    stats = calibrate_activation_scales(params, spec, ids)
    w8a8 = apply_activation_scales(quantize_params(params, spec, "int8"),
                                   stats)
    delta = abs(ppl(w8a8) - base)
    # random-weight tiny model: logits are near-uniform so ppl is flat; the
    # assert guards the path runs end-to-end and stays numerically sane
    assert delta < 0.5 * base, (delta, base)


def test_streamed_quantized_init_matches_init_then_quantize():
    """streamed_quantized_init (the low-peak 7B ppl-gate path) produces
    bit-identical QTensors to quantize_params(init_params(...)) — it must
    replicate init_params' per-leaf PRNG key layout exactly."""
    from mlio_tpu.models import get_spec, init_params
    from mlio_tpu.ops.quant import QTensor
    from mlio_tpu.runtime.quantization import (
        quantize_params,
        streamed_quantized_init,
    )

    for preset in ("gpt2-tiny", "llama-tiny", "moe-tiny"):
        spec = get_spec(preset)
        key = jax.random.PRNGKey(7)
        # donate=True is the jitted conversion the ppl gate's small legs
        # use; the streamed path must match it bit-for-bit
        ref = quantize_params(
            init_params(spec, key, dtype=jnp.bfloat16), spec, "int8",
            donate=True, quantize_lm_head=True)
        got = streamed_quantized_init(spec, key, "int8")
        for name, r in ref["blocks"].items():
            g = got["blocks"][name]
            if r is None:
                assert g is None, name
            elif isinstance(r, QTensor):
                assert jnp.array_equal(r.q, g.q), name
                assert jnp.array_equal(r.scale, g.scale), name
            else:
                assert jnp.array_equal(r, g), name
        for name in ("tok_embed", "pos_embed", "lm_head", "final_scale"):
            r, g = ref[name], got[name]
            assert (r is None) == (g is None), name
            if isinstance(r, QTensor):
                assert jnp.array_equal(r.q, g.q), name
                assert jnp.array_equal(r.scale, g.scale), name
            elif r is not None:
                assert jnp.array_equal(r, g), name
