"""The public per-kernel validate/benchmark surface (ops/validation.py).

Reference parity: the reference's inline validate_*/benchmark_* functions
(SURVEY §4 "Kernel-level correctness"): validate_fused_mlp
mlp_kernels.py:925, compare_with_standard_attention
flash_attention_kernels.py:1876.
"""
import pytest

from mlio_tpu.ops import validation as V


def test_validate_all_passes():
    results = V.validate_all(interpret=True)
    failed = {k: r for k, r in results.items() if not r["passed"]}
    assert not failed, f"kernel gates failed: {failed}"
    # every family must be covered
    for key in ("flash_attention", "ring_attention", "paged_attention",
                "decode_attention", "quant_linear_int8", "moe_ragged"):
        assert key in results
        assert results[key]["reason"]


def test_memory_models():
    mem = V.benchmark_attention_memory(seqs=(512, 2048))
    # dense score memory grows quadratically, flash linearly
    r0, r1 = mem["memory"]
    assert r1["dense_bytes"] == 16 * r0["dense_bytes"]
    assert r1["flash_bytes"] == 4 * r0["flash_bytes"]
    assert r1["reduction"] > r0["reduction"]

    mlp_mem = V.profile_mlp_memory()
    assert 0.3 < mlp_mem["bandwidth_reduction"] < 0.7  # README 40-60% claim


def test_benchmark_op_returns_marginal():
    import jax.numpy as jnp

    x = jnp.ones((128, 128), jnp.float32)
    r = V.benchmark_op(lambda: x @ x, short=4, long=12)
    assert r["seconds_per_call"] > 0
    assert r["calls_per_sec"] > 0


@pytest.mark.parametrize("activation", ["relu", "swiglu"])
def test_benchmark_fused_mlp_smoke(activation):
    r = V.benchmark_fused_mlp(batch=1, seq=64, hidden=128, intermediate=256,
                              activation=activation)
    assert r["bf16_seconds"] > 0 and r["int8_seconds"] > 0
