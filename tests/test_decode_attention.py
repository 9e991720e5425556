"""Decode attention over the contiguous cache (the paged Triton-route
kernel over a page view of the cache, interpret mode) vs dense reference."""
import jax.numpy as jnp
import numpy as np
import pytest

from mlio_tpu.ops.paged_attention import (contiguous_pages, decode_attention,
                                          decode_launch)
from mlio_tpu.ops.reference import attention_reference
from mlio_tpu.ops.quant import quantize_kv


def _dense(q, k_cache, v_cache, ctx, layer):
    B, Hq, D = q.shape
    k = k_cache[layer]
    v = v_cache[layer]
    out = attention_reference(q.reshape(B, 1, Hq, D), k, v,
                              causal=False, kv_len=ctx)
    return out[:, 0]


@pytest.mark.parametrize("gqa", [1, 4])
def test_matches_dense(rng, gqa):
    B, L, Smax, Hq, D = 4, 3, 256, 8, 64
    Hkv = Hq // gqa
    q = jnp.asarray(rng.standard_normal((B, Hq, D)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((L, B, Smax, Hkv, D)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((L, B, Smax, Hkv, D)), jnp.float32)
    ctx = jnp.asarray([1, 17, 130, 256], jnp.int32)  # ragged contexts
    for layer in (0, 2):
        out = decode_attention(q, k, v, ctx, layer=layer, interpret=True)
        ref = _dense(q, k, v, ctx, layer)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=2e-3, atol=2e-3)


def test_int8_kv_close_to_fp(rng):
    B, L, Smax, Hkv, D = 2, 2, 128, 4, 64
    q = jnp.asarray(rng.standard_normal((B, Hkv, D)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((L, B, Smax, Hkv, D)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((L, B, Smax, Hkv, D)), jnp.float32)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    ctx = jnp.asarray([40, 128], jnp.int32)
    out = decode_attention(q, kq, vq, ctx, layer=1, k_scales=ks, v_scales=vs,
                           interpret=True)
    ref = _dense(q, k, v, ctx, 1)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=0.05, atol=0.05)


def test_tile_chooser_respects_vmem():
    """Page view and launch shape: power-of-two pages dividing Smax, loop
    blocks of >= 16 keys (the tensor-core dot's minimum), splits that cover
    every block and give B=8 x Hkv=8 about two programs per SM."""
    assert contiguous_pages(4096) == 64 and contiguous_pages(1152) == 64
    assert contiguous_pages(20) == 4 and contiguous_pages(21) == 1
    ppb, splits, per = decode_launch(8, 8, 256, 16)
    assert ppb * 16 == 64 and per % ppb == 0
    assert splits * per >= 256 and (splits - 1) * per < 256
    assert 8 * 8 * splits >= 132
    # one sequence, tiny context: a single split, never empty
    ppb, splits, per = decode_launch(1, 1, 2, 16)
    assert splits == 1 and per >= 2
    for bs in (1, 4, 16, 64, 128):
        ppb, _, _ = decode_launch(8, 8, 64, bs)
        assert ppb * bs >= 16 and (ppb * bs) & (ppb * bs - 1) == 0
