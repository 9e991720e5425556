"""INT8 KV-cache tests: quantizers, the flash path's dequant, contiguous
cache decode, paged pools (the BASELINE.md INT8-KV capability)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mlio_tpu.models import Impl, forward, get_spec, init_params
from mlio_tpu.ops import attention
from mlio_tpu.ops.quant import dequantize_kv, quantize_kv
from mlio_tpu.ops.reference import attention_reference
from mlio_tpu.runtime import init_cache


def test_quantize_kv_roundtrip():
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 7, 3, 16))
    q, s = quantize_kv(x)
    assert q.dtype == jnp.int8 and s.shape == (2, 7, 3)
    back = dequantize_kv(q, s)
    err = np.abs(np.asarray(back) - np.asarray(x))
    bound = np.asarray(s)[..., None] / 2 + 1e-6
    assert (err <= bound).all()


def test_flash_kernel_int8_kv_matches_dequant_dense():
    B, Sq, Skv, Hq, Hkv, D = 2, 64, 128, 4, 2, 64
    key = jax.random.PRNGKey(1)
    q = jax.random.normal(key, (B, Sq, Hq, D))
    k = jax.random.normal(jax.random.PRNGKey(2), (B, Skv, Hkv, D))
    v = jax.random.normal(jax.random.PRNGKey(3), (B, Skv, Hkv, D))
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)

    out = attention(q, kq, vq, causal=True, q_offset=0, kv_len=100,
                    k_scale=ks, v_scale=vs,
                    impl=Impl(attention="flash", interpret=True))
    ref = attention_reference(q, dequantize_kv(kq, ks), dequantize_kv(vq, vs),
                              causal=True, kv_len=100)
    # bf16 internal rounding in the kernel's int8 path
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=2e-2, atol=2e-2)
    # and close to the unquantized truth (int8 noise)
    true = attention_reference(q, k, v, causal=True, kv_len=100)
    assert np.abs(np.asarray(out) - np.asarray(true)).max() < 0.1


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_model_decode_with_int8_cache(name):
    """Cached decode with INT8 KV must track the fp32-cache decode."""
    spec = get_spec(name)
    params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    ids = jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0,
                             spec.vocab_size)

    cache_fp = init_cache(spec, 2, 32, dtype=jnp.float32)
    cache_q = init_cache(spec, 2, 32, quant="int8")
    assert cache_q["k"].dtype == jnp.int8

    lf, cache_fp = forward(params, spec, ids[:, :8], cache=cache_fp)
    lq, cache_q = forward(params, spec, ids[:, :8], cache=cache_q)
    assert int(cache_q["pos"]) == 8
    # prefill logits: last position differs only by int8 cache noise
    rel = (np.abs(np.asarray(lf) - np.asarray(lq)).max()
           / np.abs(np.asarray(lf)).max())
    assert rel < 0.05, rel

    # decode steps stay close
    for t in range(8, 12):
        sf, cache_fp = forward(params, spec, ids[:, t:t+1], cache=cache_fp)
        sq, cache_q = forward(params, spec, ids[:, t:t+1], cache=cache_q)
        rel = (np.abs(np.asarray(sf) - np.asarray(sq)).max()
               / np.abs(np.asarray(sf)).max())
        assert rel < 0.08, (t, rel)


def test_generate_with_int8_cache():
    from mlio_tpu.runtime import generate
    from mlio_tpu.runtime.sampling import SamplingMethod

    spec = get_spec("llama-tiny")
    params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    ids = jnp.asarray([[1, 2, 3, 4]])
    out = generate(params, spec, ids, max_new_tokens=6,
                   method=SamplingMethod(temperature=0.0),
                   cache_quant="int8")
    assert out.shape == (1, 10)
    # greedy with fp cache for comparison — token drift allowed but output
    # must be valid token ids
    assert (np.asarray(out) >= 0).all()


def test_paged_int8_pools_match_dense():
    from mlio_tpu.ops.paged_attention import (
        init_kv_pools,
        paged_attention,
        reshape_and_cache_quant,
    )

    B, L, NB, Hq, Hkv, bs, D = 2, 2, 16, 4, 2, 16, 32
    k_pool, v_pool, ks_pool, vs_pool = init_kv_pools(L, NB, Hkv, bs, D,
                                                     quant="int8")
    tables = jnp.asarray([[1, 2, 0, 0], [3, 5, 7, 0]], jnp.int32)
    ctx = jnp.asarray([20, 33], jnp.int32)
    S = 33
    k_new = jax.random.normal(jax.random.PRNGKey(0), (B, S, Hkv, D))
    v_new = jax.random.normal(jax.random.PRNGKey(1), (B, S, Hkv, D))
    layer = 1
    k_pool, v_pool, ks_pool, vs_pool = reshape_and_cache_quant(
        k_pool, v_pool, ks_pool, vs_pool, k_new, v_new, tables,
        jnp.zeros((B,), jnp.int32), layer)
    q = jax.random.normal(jax.random.PRNGKey(2), (B, Hq, D))
    out = paged_attention(q, k_pool, v_pool, tables, ctx, layer=layer,
                          k_scale_pool=ks_pool, v_scale_pool=vs_pool,
                          interpret=True)
    ref = attention_reference(q[:, None], k_new, v_new, causal=False,
                              kv_len=ctx)[:, 0]
    assert np.abs(np.asarray(out) - np.asarray(ref)).max() < 0.1  # int8 noise
