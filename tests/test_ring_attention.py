"""Ring/chunked/sequence-parallel attention vs dense reference.

The reference's ring softmax was WRONG twice (SURVEY.md §2.9.12) — these are
the property tests the survey prescribes: every strategy must match dense
attention exactly (not approximately-per-chunk). Collectives run for real on
the 8-device CPU mesh (conftest).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mlio_tpu.ops.reference import attention_reference
from mlio_tpu.ops.ring_attention import chunked_ring_attention
from mlio_tpu.parallel import make_mesh
from mlio_tpu.parallel.sequence_parallel import (
    scatter_sequence,
    sequence_parallel_attention,
)


def _qkv(key, B, S, Hq, Hkv, D):
    kq, kk, kv = jax.random.split(key, 3)
    return (jax.random.normal(kq, (B, S, Hq, D)),
            jax.random.normal(kk, (B, S, Hkv, D)),
            jax.random.normal(kv, (B, S, Hkv, D)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [64, 100, 256])
def test_chunked_matches_dense(causal, chunk):
    q, k, v = _qkv(jax.random.PRNGKey(0), 2, 256, 4, 2, 32)
    out = chunked_ring_attention(q, k, v, causal=causal, chunk_size=chunk)
    ref = attention_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_chunked_decode_with_kv_len():
    q, k, v = _qkv(jax.random.PRNGKey(1), 2, 128, 4, 4, 32)
    out = chunked_ring_attention(q[:, :1], k, v, causal=True, q_offset=57,
                                 kv_len=58, chunk_size=32)
    ref = attention_reference(q[:, :1], k, v, causal=True, q_offset=57,
                              kv_len=58)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("strategy", ["ring", "full", "ulysses"])
@pytest.mark.parametrize("causal", [True, False])
def test_sequence_parallel_matches_dense(strategy, causal):
    """Distributed attention over a real 8-device seq mesh == dense."""
    mesh = make_mesh(seq=8)
    B, S, Hq, Hkv, D = 2, 128, 8, 8, 32
    if strategy == "ulysses":
        Hkv = Hq  # ulysses shards heads; keep MHA for the test
    q, k, v = _qkv(jax.random.PRNGKey(2), B, S, Hq, Hkv, D)
    qs = scatter_sequence(q, mesh)
    ks = scatter_sequence(k, mesh)
    vs = scatter_sequence(v, mesh)
    out = sequence_parallel_attention(qs, ks, vs, mesh, causal=causal,
                                      strategy=strategy)
    ref = attention_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_sequence_parallel_ring_gqa():
    mesh = make_mesh(seq=4)
    q, k, v = _qkv(jax.random.PRNGKey(3), 1, 64, 8, 2, 32)
    out = sequence_parallel_attention(
        scatter_sequence(q, mesh), scatter_sequence(k, mesh),
        scatter_sequence(v, mesh), mesh, causal=True, strategy="ring")
    ref = attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_local_strategy_is_block_diagonal():
    """'local' is intentionally approximate: block-diagonal attention."""
    mesh = make_mesh(seq=4)
    q, k, v = _qkv(jax.random.PRNGKey(4), 1, 64, 4, 4, 32)
    out = sequence_parallel_attention(
        scatter_sequence(q, mesh), scatter_sequence(k, mesh),
        scatter_sequence(v, mesh), mesh, causal=True, strategy="local")
    # block 0 must equal dense on the first 16 positions...
    ref0 = attention_reference(q[:, :16], k[:, :16], v[:, :16], causal=True)
    np.testing.assert_allclose(np.asarray(out[:, :16]), np.asarray(ref0),
                               rtol=1e-5, atol=1e-5)
    # ...but later blocks must NOT see earlier keys (different from dense)
    ref_full = attention_reference(q, k, v, causal=True)
    assert np.abs(np.asarray(out[:, 16:]) - np.asarray(ref_full[:, 16:])).max() > 1e-3


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_flash_path_matches_dense(causal):
    """The flash dispatch (cuDNN's argument mapping, run as XLA's
    implementation in interpret mode) == dense, with GQA."""
    from mlio_tpu import ops
    from mlio_tpu.models import Impl

    q, k, v = _qkv(jax.random.PRNGKey(5), 2, 256, 4, 2, 32)
    out = ops.attention(q, k, v, causal=causal,
                        impl=Impl(attention="flash", interpret=True))
    ref = attention_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=2e-3, atol=2e-3)


def test_chunked_flash_path_decode_with_kv_len():
    """A query placed after cached context (q_offset, kv_len) through the
    flash dispatch's explicit offset mask."""
    from mlio_tpu import ops
    from mlio_tpu.models import Impl

    q, k, v = _qkv(jax.random.PRNGKey(6), 2, 128, 4, 4, 32)
    out = ops.attention(q[:, :1], k, v, causal=True, q_offset=57, kv_len=58,
                        impl=Impl(attention="flash", interpret=True))
    ref = attention_reference(q[:, :1], k, v, causal=True, q_offset=57,
                              kv_len=58)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=2e-3, atol=2e-3)


def test_flash_return_stats_lse():
    """The chunked (m, l) statistics give the row log-sum-exp of the
    scaled scores: lse = m + log(l)."""
    from mlio_tpu.ops.ring_attention import chunk_step, init_stats

    q, k, v = _qkv(jax.random.PRNGKey(7), 2, 64, 4, 4, 32)
    scale = 32 ** -0.5
    m, l, acc = init_stats(2, 4, 64, 32)
    for c in range(0, 64, 16):
        m, l, acc = chunk_step(q, k[:, c:c + 16], v[:, c:c + 16], m, l, acc,
                               scale=scale, q_positions=jnp.arange(64),
                               k_positions=c + jnp.arange(16), causal=True)
    lse = (m + jnp.log(l))[..., 0]
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = jnp.arange(64)[:, None] >= jnp.arange(64)[None, :]
    s = jnp.where(mask[None, None], s, -jnp.inf)
    ref_lse = jax.scipy.special.logsumexp(s, axis=-1)
    np.testing.assert_allclose(np.asarray(lse), np.asarray(ref_lse),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("strategy", ["ring", "full", "ulysses"])
def test_sequence_parallel_flash_path(strategy):
    """Distributed strategies with grouped KV heads on the 8-device CPU
    mesh == dense."""
    mesh = make_mesh(seq=4)
    B, S, Hq, Hkv, D = 1, 128, 8, 4, 32
    q, k, v = _qkv(jax.random.PRNGKey(8), B, S, Hq, Hkv, D)
    out = sequence_parallel_attention(
        scatter_sequence(q, mesh), scatter_sequence(k, mesh),
        scatter_sequence(v, mesh), mesh, causal=True, strategy=strategy)
    ref = attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=2e-3, atol=2e-3)
