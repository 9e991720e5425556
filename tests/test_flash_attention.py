"""Flash attention (cuDNN through jax.nn.dot_product_attention) vs dense
reference (parity with the reference's validate pattern, e.g.
compare_with_standard_attention flash_attention_kernels.py:1876).

On the CPU the wrapper runs in interpret mode: the same argument mapping
(causal, q_offset masks, kv lengths) handed to XLA's implementation of the
call. cuDNN itself is checked on the card (chip_smoke.py, and the ``gpu``
tests below). User masks stay on the dense reference; those tests check the
reference's mask semantics against independent constructions."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mlio_tpu.ops.flash_attention import flash_attention
from mlio_tpu.ops.reference import attention_reference, canonicalize_mask


def _rand_qkv(key, B, Sq, Skv, Hq, Hkv, D, dtype=jnp.float32):
    kq, kk, kv = jax.random.split(key, 3)
    q = jax.random.normal(kq, (B, Sq, Hq, D), dtype)
    k = jax.random.normal(kk, (B, Skv, Hkv, D), dtype)
    v = jax.random.normal(kv, (B, Skv, Hkv, D), dtype)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "B,Sq,Skv,Hq,Hkv,D",
    [
        (2, 256, 256, 4, 4, 64),     # MHA, even blocks
        (1, 200, 200, 4, 2, 64),     # GQA, ragged seq (padding path)
        (2, 128, 128, 4, 1, 64),     # MQA
        (1, 384, 384, 2, 2, 128),    # D=128
    ],
)
def test_flash_matches_dense(causal, B, Sq, Skv, Hq, Hkv, D):
    q, k, v = _rand_qkv(jax.random.PRNGKey(0), B, Sq, Skv, Hq, Hkv, D)
    out = flash_attention(q, k, v, causal=causal, interpret=True)
    ref = attention_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-3, atol=1e-3)


def test_flash_decode_with_cache_mask():
    """Sq=1 decode against a static cache with kv_len < Skv."""
    B, Smax, Hq, Hkv, D = 2, 128, 4, 2, 64
    q, k, v = _rand_qkv(jax.random.PRNGKey(1), B, 1, Smax, Hq, Hkv, D)
    kv_len = 37  # only the first 37 cache slots are valid
    out = flash_attention(q, k, v, causal=True, q_offset=kv_len - 1,
                          kv_len=kv_len, interpret=True)
    ref = attention_reference(q, k, v, causal=True, q_offset=kv_len - 1,
                              kv_len=kv_len)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-3, atol=1e-3)


def test_flash_prefill_chunk_with_offset():
    """Chunked prefill: queries at offset into a longer valid context."""
    B, Sq, Skv, Hq, Hkv, D = 1, 64, 256, 4, 4, 64
    q, k, v = _rand_qkv(jax.random.PRNGKey(2), B, Sq, Skv, Hq, Hkv, D)
    out = flash_attention(q, k, v, causal=True, q_offset=100, kv_len=164,
                          interpret=True)
    ref = attention_reference(q, k, v, causal=True, q_offset=100, kv_len=164)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-3, atol=1e-3)


def test_flash_per_batch_kv_len():
    B, Sq, Skv, Hq, Hkv, D = 3, 1, 64, 2, 2, 32
    q, k, v = _rand_qkv(jax.random.PRNGKey(3), B, Sq, Skv, Hq, Hkv, D)
    kv_len = jnp.asarray([5, 17, 64], jnp.int32)
    out = flash_attention(q, k, v, causal=False, kv_len=kv_len, interpret=True)
    ref = attention_reference(q, k, v, causal=False, kv_len=kv_len)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-3, atol=1e-3)


def test_flash_bf16():
    B, Sq, Skv, Hq, Hkv, D = 1, 128, 128, 4, 4, 64
    q, k, v = _rand_qkv(jax.random.PRNGKey(4), B, Sq, Skv, Hq, Hkv, D,
                        dtype=jnp.bfloat16)
    out = flash_attention(q, k, v, causal=True, interpret=True)
    ref = attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32),
        rtol=2e-2, atol=2e-2)


def test_flash_in_model_forward():
    """End-to-end: Impl(attention='flash') must match the dense model."""
    from mlio_tpu.models import Impl, forward, get_spec, init_params

    spec = get_spec("llama-tiny")
    params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    ids = jax.random.randint(jax.random.PRNGKey(1), (2, 24), 0, spec.vocab_size)
    dense, _ = forward(params, spec, ids)
    flash, _ = forward(params, spec, ids, impl=Impl(attention="flash", interpret=True))
    np.testing.assert_allclose(np.asarray(flash), np.asarray(dense),
                               rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# User attention masks (VERDICT #4: left-padding, per-token, bidirectional,
# full masks — parity with flash_attention_kernels.py:1232-1271 in-kernel
# mask tiles).


def _left_pad_mask(key, B, S, max_pad):
    pads = jax.random.randint(key, (B,), 0, max_pad + 1)
    return (jnp.arange(S)[None, :] >= pads[:, None]).astype(jnp.int8), pads


def _as_bias(mask):
    return jnp.where(mask != 0, 0.0, -jnp.inf)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_key_mask_left_padding(causal):
    """A left-padding key mask equals attention over the unpadded keys."""
    B, S, Hq, Hkv, D = 3, 256, 4, 2, 64
    q, k, v = _rand_qkv(jax.random.PRNGKey(3), B, S, S, Hq, Hkv, D)
    mask, pads = _left_pad_mask(jax.random.PRNGKey(4), B, S, 100)
    out = attention_reference(q, k, v, causal=causal, mask=mask)
    for b in range(B):
        p = int(pads[b])
        ref = attention_reference(q[b:b + 1], k[b:b + 1, p:], v[b:b + 1, p:],
                                  causal=causal, q_offset=-p)
        rows = slice(p, S) if causal else slice(0, S)
        np.testing.assert_allclose(np.asarray(out[b:b + 1, rows]),
                                   np.asarray(ref[:, rows]),
                                   rtol=1e-3, atol=1e-3)


def test_flash_key_mask_random_tokens():
    """Arbitrary per-token key mask (holes in the middle) == -inf bias."""
    B, S, Hq, Hkv, D = 2, 192, 4, 4, 64
    q, k, v = _rand_qkv(jax.random.PRNGKey(5), B, S, S, Hq, Hkv, D)
    mask = jax.random.bernoulli(jax.random.PRNGKey(6), 0.8, (B, S))
    mask = mask.at[:, 0].set(True)  # keep at least one valid key per row
    out = attention_reference(q, k, v, causal=True, mask=mask.astype(jnp.int8))
    ref = attention_reference(q, k, v, causal=True,
                              bias=_as_bias(mask)[:, None, None, :])
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-3, atol=1e-3)


def test_flash_full_mask_3d_prefix_lm():
    """[B, Sq, Skv] mask: bidirectional prefix + causal tail (prefix-LM)."""
    B, S, Hq, Hkv, D = 2, 128, 4, 4, 64
    q, k, v = _rand_qkv(jax.random.PRNGKey(7), B, S, S, Hq, Hkv, D)
    prefix = 40
    causal_m = jnp.tril(jnp.ones((S, S), jnp.bool_))
    prefix_m = (jnp.arange(S)[None, :] < prefix) | causal_m
    mask = jnp.broadcast_to(prefix_m[None], (B, S, S))
    out = attention_reference(q, k, v, causal=False,
                              mask=mask.astype(jnp.int8))
    ref = attention_reference(q, k, v, causal=False,
                              bias=_as_bias(mask)[:, None])
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-3, atol=1e-3)
    # the causal tail past the prefix is plain causal attention
    causal = attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(np.asarray(out[:, prefix:]),
                               np.asarray(causal[:, prefix:]),
                               rtol=1e-3, atol=1e-3)


def test_flash_full_mask_4d_per_head():
    B, S, Hq, Hkv, D = 1, 128, 4, 2, 64
    q, k, v = _rand_qkv(jax.random.PRNGKey(8), B, S, S, Hq, Hkv, D)
    mask = jax.random.bernoulli(jax.random.PRNGKey(9), 0.7, (B, Hq, S, S))
    mask = mask.at[..., 0].set(True)
    out = attention_reference(q, k, v, causal=False,
                              mask=mask.astype(jnp.int8))
    ref = attention_reference(q, k, v, causal=False, bias=_as_bias(mask))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-3, atol=1e-3)


def test_flash_key_mask_with_int8_kv():
    """Key mask combined with an INT8 KV cache through the dispatcher ==
    the same mask over explicitly dequantized K/V."""
    from mlio_tpu import ops
    from mlio_tpu.ops.quant import dequantize_kv, quantize_kv

    B, S, Hq, Hkv, D = 2, 128, 4, 2, 64
    q, k, v = _rand_qkv(jax.random.PRNGKey(10), B, S, S, Hq, Hkv, D)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    mask, _ = _left_pad_mask(jax.random.PRNGKey(11), B, S, 50)
    out = ops.attention(q, kq, vq, causal=True, mask=mask, k_scale=ks,
                        v_scale=vs)
    ref = attention_reference(q, dequantize_kv(kq, ks), dequantize_kv(vq, vs),
                              causal=True, mask=mask)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_flash_full_mask_int8_kv_unsupported():
    """The flash path takes no user mask: it raises instead of handing the
    call to another path."""
    from mlio_tpu import ops
    from mlio_tpu.models import Impl
    from mlio_tpu.ops.quant import quantize_kv

    B, S, Hq, Hkv, D = 1, 128, 2, 2, 64
    q, k, v = _rand_qkv(jax.random.PRNGKey(12), B, S, S, Hq, Hkv, D)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    mask = jnp.ones((B, S, S), jnp.int8)
    with pytest.raises(NotImplementedError):
        ops.attention(q, kq, vq, causal=True, mask=mask, k_scale=ks,
                      v_scale=vs, impl=Impl(attention="flash", interpret=True))


def test_flash_mask_chunked_long_context():
    """Per-sequence kv lengths at a longer context through the flash
    mapping (key_value_seq_lengths)."""
    B, S, Hq, Hkv, D = 2, 512, 2, 2, 64
    q, k, v = _rand_qkv(jax.random.PRNGKey(13), B, S, S, Hq, Hkv, D)
    kv_len = jnp.asarray([512, 301], jnp.int32)
    out = flash_attention(q, k, v, causal=True, kv_len=kv_len, interpret=True)
    ref = attention_reference(q, k, v, causal=True, kv_len=kv_len)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-3, atol=1e-3)


def test_canonicalize_mask_shapes():
    B, Hq, Sq, Skv = 2, 4, 8, 16
    kind, m = canonicalize_mask(jnp.ones((B, Skv)), B, Hq, Sq, Skv)
    assert kind == "key" and m.shape == (B, Skv)
    kind, m = canonicalize_mask(jnp.ones((B, 1, Skv)), B, Hq, Sq, Skv)
    assert kind == "key" and m.shape == (B, Skv)
    kind, m = canonicalize_mask(jnp.ones((B, Sq, Skv)), B, Hq, Sq, Skv)
    assert kind == "full" and m.shape == (B, 1, Sq, Skv)
    kind, m = canonicalize_mask(jnp.ones((B, Hq, Sq, Skv)), B, Hq, Sq, Skv)
    assert kind == "full" and m.shape == (B, Hq, Sq, Skv)
    with pytest.raises(ValueError):
        canonicalize_mask(jnp.ones((B, 3, Skv)), B, Hq, Sq, Skv)


def test_flash_streamed_long_context_matches_dense():
    """Sq != Skv through the flash mapping, incl. kv_len and a
    decode-style q_offset."""
    rng = jax.random.PRNGKey(9)
    B, Sq, Skv, H, D = 2, 256, 384, 2, 64
    q, k, v = (jax.random.normal(r, (B, s, H, D), jnp.float32)
               for r, s in zip(jax.random.split(rng, 3), (Sq, Skv, Skv)))
    for causal in (True, False):
        out = flash_attention(q, k, v, causal=causal, interpret=True)
        ref = attention_reference(q, k, v, causal=causal)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   atol=2e-3, rtol=2e-3)
    kvl = jnp.asarray([300, 120], jnp.int32)
    out = flash_attention(q[:, :1], k, v, causal=True, q_offset=100,
                          kv_len=kvl, interpret=True)
    ref = attention_reference(q[:, :1], k, v, causal=True, q_offset=100,
                              kv_len=kvl)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-3, rtol=2e-3)


def test_flash_streamed_gqa():
    """Grouped KV heads (Hq=4, Hkv=2) with Sq < Skv."""
    rng = jax.random.PRNGKey(10)
    B, Sq, Skv, Hq, Hkv, D = 1, 128, 256, 4, 2, 64
    ks = jax.random.split(rng, 3)
    q = jax.random.normal(ks[0], (B, Sq, Hq, D), jnp.float32)
    k = jax.random.normal(ks[1], (B, Skv, Hkv, D), jnp.float32)
    v = jax.random.normal(ks[2], (B, Skv, Hkv, D), jnp.float32)
    out = flash_attention(q, k, v, causal=True, interpret=True)
    ref = attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("q_offset", [0, 64])
def test_flash_cudnn_on_card(gpu, q_offset):
    """cuDNN itself, bf16, GQA, against the f32 reference."""
    from mlio_tpu.ops.validation import validate_flash_attention

    r = validate_flash_attention(batch=2, seq=256, heads=8, kv_heads=2,
                                 head_dim=128, q_offset=q_offset)
    assert r["passed"], r
