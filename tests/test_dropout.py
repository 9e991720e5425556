"""Position-hashed attention dropout (ops/dropmask.py) across all paths.

Because the mask is a stateless hash of absolute positions, any evaluation
of the same (seed, position) drops the same elements — tests compare exactly
against explicit masks, not statistically (statistics are still
sanity-checked once). Dropout runs on the dense reference path; the flash
path (cuDNN) rejects it.
Parity: reference FlashAttentionConfig.dropout + return_softmax
(/root/reference/kernels/attention/flash_attention.py:53-104).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mlio_tpu.ops import attention
from mlio_tpu.ops.dropmask import dense_keep_mask, keep_u01
from mlio_tpu.ops.reference import attention_reference
from mlio_tpu.models.transformer import Impl


def _qkv(B=2, S=192, H=3, D=64, dtype=jnp.float32, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (jax.random.normal(ks[0], (B, S, H, D), dtype),
            jax.random.normal(ks[1], (B, S, H, D), dtype),
            jax.random.normal(ks[2], (B, S, H, D), dtype))


def test_hash_statistics():
    """Keep-rate and uniformity of the position hash."""
    i = jnp.arange(512, dtype=jnp.int32)[:, None]
    j = jnp.arange(512, dtype=jnp.int32)[None, :]
    u = np.asarray(keep_u01(i, j, 1234))
    assert abs(u.mean() - 0.5) < 0.01
    for rate in (0.1, 0.5):
        assert abs((u >= rate).mean() - (1 - rate)) < 0.01
    # decorrelated across seeds
    u2 = np.asarray(keep_u01(i, j, 77))
    assert abs(((u >= 0.5) == (u2 >= 0.5)).mean() - 0.5) < 0.02


def _explicit_dropout(q, k, v, rate, seed):
    """Softmax attention with the hash mask applied by hand."""
    B, S, H, D = q.shape
    probs = attention_reference(q, k, v, causal=True, return_probs=True)[1]
    keep = dense_keep_mask(B, H, S, S, seed, rate)
    pv = jnp.where(keep, probs, 0.0) / (1.0 - rate)
    return jnp.einsum("bhqk,bkhd->bqhd", pv, v)


def test_flash_dropout_matches_reference_exactly():
    q, k, v = _qkv()
    for rate in (0.15, 0.5):
        out_f = attention(q, k, v, causal=True, dropout_rate=rate,
                          dropout_seed=42)
        out_r = _explicit_dropout(q, k, v, rate, 42)
        np.testing.assert_allclose(np.asarray(out_f), np.asarray(out_r),
                                   atol=3e-5, rtol=3e-5)
    # different seeds give different outputs
    out_b = attention(q, k, v, causal=True, dropout_rate=0.5,
                      dropout_seed=43)
    assert not np.allclose(np.asarray(out_f), np.asarray(out_b))


def test_dropout_blocking_invariance():
    """The mask hashes absolute positions: a query block evaluated on its
    own (q_offset) drops exactly what the full evaluation drops."""
    q, k, v = _qkv(S=256)
    full = attention_reference(q, k, v, causal=True, dropout_rate=0.3,
                               dropout_seed=7)
    tail = attention_reference(q[:, 128:], k, v, causal=True, q_offset=128,
                               dropout_rate=0.3, dropout_seed=7)
    np.testing.assert_allclose(np.asarray(full[:, 128:]), np.asarray(tail),
                               atol=2e-5, rtol=2e-5)


def test_vjp_dropout_grads_match_dense():
    """jax.grad through the reference with dropout equals the gradient of
    the explicitly masked computation (same hash mask)."""
    q, k, v = _qkv(B=1, S=128, H=2, D=64)
    rate, seed = 0.25, 11

    def loss_ref(q, k, v):
        o = attention_reference(q, k, v, causal=True, dropout_rate=rate,
                                dropout_seed=seed)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    def loss_explicit(q, k, v):
        return jnp.sum(_explicit_dropout(q, k, v, rate, seed) ** 2)

    gf = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    gd = jax.grad(loss_explicit, argnums=(0, 1, 2))(q, k, v)
    for a, b, n in zip(gf, gd, "qkv"):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-3, rtol=2e-3, err_msg=n)


def test_return_probs_surface():
    """ops.attention(return_probs=True) returns the softmax matrix
    (reference's return_softmax debug surface)."""
    q, k, v = _qkv(S=64)
    out, probs = attention(q, k, v, causal=True, return_probs=True,
                           impl=Impl(attention="flash", interpret=True))
    assert probs.shape == (2, 3, 64, 64)
    rows = np.asarray(probs.sum(-1))
    np.testing.assert_allclose(rows, np.ones_like(rows), atol=1e-5)
    # upper triangle is masked
    assert float(jnp.triu(probs[0, 0], k=1).sum()) == 0.0
    out_plain = attention(q, k, v, causal=True, impl=Impl(attention="flash", interpret=True))
    np.testing.assert_allclose(np.asarray(out), np.asarray(out_plain),
                               atol=3e-3, rtol=3e-3)


def test_dropout_dispatcher_dense_and_flash_agree():
    """Dropout is a dense-path feature: the dense dispatch applies it, the
    flash dispatch raises rather than silently dropping it."""
    q, k, v = _qkv(S=128)
    a = attention(q, k, v, causal=True, dropout_rate=0.2, dropout_seed=5,
                  impl=Impl())
    b = attention_reference(q, k, v, causal=True, dropout_rate=0.2,
                            dropout_seed=5)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               atol=1e-6, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        attention(q, k, v, causal=True, dropout_rate=0.2, dropout_seed=5,
                  impl=Impl(attention="flash", interpret=True))


def test_dropout_int8_kv_rejected():
    q, k, v = _qkv(S=128)
    ksc = jnp.ones((2, 128, 3), jnp.float32)
    with pytest.raises(NotImplementedError):
        attention(q, k.astype(jnp.int8), v.astype(jnp.int8), causal=True,
                  dropout_rate=0.1, k_scale=ksc, v_scale=ksc,
                  impl=Impl(attention="flash", interpret=True))
