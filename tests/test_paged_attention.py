"""PagedAttention kernel + reshape_and_cache vs dense reference
(parity: the reference's paged path, attention_kernels.py:628-905)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mlio_tpu.ops.paged_attention import (
    init_kv_pools,
    paged_attention,
    paged_attention_reference,
    reshape_and_cache,
)
from mlio_tpu.ops.reference import attention_reference


def _setup(B=3, L=2, NB=32, Hkv=2, Hq=4, bs=16, D=64, seed=0):
    k_pool, v_pool = init_kv_pools(L, NB, Hkv, bs, D, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    # distinct context length per sequence; blocks allocated non-contiguously
    ctx = np.array([7, 30, 45][:B], np.int32)
    max_blocks = 4
    tables = np.zeros((B, max_blocks), np.int32)
    used = set()
    free = [b for b in range(1, NB)]
    rng.shuffle(free)
    for b in range(B):
        n = -(-int(ctx[b]) // bs)
        for j in range(n):
            tables[b, j] = free.pop()
    return k_pool, v_pool, jnp.asarray(tables), jnp.asarray(ctx), Hq, D


def test_reshape_and_cache_then_read_back():
    k_pool, v_pool, tables, ctx, Hq, D = _setup()
    B = tables.shape[0]
    Hkv = k_pool.shape[3]
    # write each sequence's full prefix (prefill-style chunked writes)
    key = jax.random.PRNGKey(0)
    S = int(ctx.max())
    k_new = jax.random.normal(key, (B, S, Hkv, D))
    v_new = jax.random.normal(jax.random.PRNGKey(1), (B, S, Hkv, D))
    for layer in range(k_pool.shape[0]):
        k_pool, v_pool = reshape_and_cache(
            k_pool, v_pool, k_new, v_new, tables,
            jnp.zeros((B,), jnp.int32), layer)
    # read back through the reference gather and compare valid positions
    kb = k_pool[0][tables]  # [B, max_blocks, bs, Hkv, D]
    k_read = kb.reshape(B, -1, Hkv, D)
    for b in range(B):
        n = int(ctx[b])
        np.testing.assert_allclose(np.asarray(k_read[b, :n]),
                                   np.asarray(k_new[b, :n]), rtol=1e-6)


@pytest.mark.parametrize("gqa", [1, 2, 4], ids=["mha", "gqa2", "gqa4"])
def test_paged_attention_matches_dense(gqa):
    B, L, NB, Hkv, bs, D = 3, 2, 32, 2, 16, 64
    Hq = Hkv * gqa
    k_pool, v_pool, tables, ctx, _, _ = _setup(B=B, L=L, NB=NB, Hkv=Hkv,
                                               bs=bs, D=D)
    # populate via reshape_and_cache
    S = int(ctx.max())
    k_new = jax.random.normal(jax.random.PRNGKey(2), (B, S, Hkv, D))
    v_new = jax.random.normal(jax.random.PRNGKey(3), (B, S, Hkv, D))
    layer = 1
    k_pool, v_pool = reshape_and_cache(k_pool, v_pool, k_new, v_new, tables,
                                       jnp.zeros((B,), jnp.int32), layer)
    q = jax.random.normal(jax.random.PRNGKey(4), (B, Hq, D))

    out = paged_attention(q, k_pool, v_pool, tables, ctx, layer=layer,
                          interpret=True)
    # dense ground truth from the raw k_new/v_new with per-batch kv_len
    ref = attention_reference(q[:, None], k_new, v_new, causal=False,
                              kv_len=ctx)[:, 0]
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    # and the gather-based reference agrees too
    ref2 = paged_attention_reference(q, k_pool, v_pool, tables, ctx,
                                     layer=layer)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref2),
                               rtol=1e-5, atol=1e-5)


def test_paged_attention_single_token_context():
    """ctx=1: exactly one valid slot, everything else masked."""
    B, L, NB, Hkv, bs, D = 1, 1, 8, 2, 16, 32
    k_pool, v_pool = init_kv_pools(L, NB, Hkv, bs, D, dtype=jnp.float32)
    tables = jnp.asarray([[3, 0, 0, 0]], jnp.int32)
    ctx = jnp.asarray([1], jnp.int32)
    k_new = jax.random.normal(jax.random.PRNGKey(0), (1, 1, Hkv, D))
    v_new = jax.random.normal(jax.random.PRNGKey(1), (1, 1, Hkv, D))
    k_pool, v_pool = reshape_and_cache(k_pool, v_pool, k_new, v_new, tables,
                                       jnp.zeros((1,), jnp.int32), 0)
    q = jax.random.normal(jax.random.PRNGKey(2), (1, Hkv, D))
    out = paged_attention(q, k_pool, v_pool, tables, ctx, layer=0,
                          interpret=True)
    # softmax over one key = that key's value
    np.testing.assert_allclose(np.asarray(out), np.asarray(v_new[:, 0]),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The Pallas-Triton decode kernel (interpret mode) against the gather
# reference: grouped heads, page sizes, ragged contexts, stale table
# entries, forced context splits, int8 pools and the contiguous-cache view.


def _random_pools(L, NB, bs, Hkv, D, seed, dtype=jnp.float32):
    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    return (jax.random.normal(ks[0], (L, NB, bs, Hkv, D)).astype(dtype),
            jax.random.normal(ks[1], (L, NB, bs, Hkv, D)).astype(dtype))


def _ragged_tables(B, max_blocks, NB, seed):
    perm = np.random.default_rng(seed).permutation(np.arange(1, NB))
    return jnp.asarray(perm[:B * max_blocks].reshape(B, max_blocks),
                       jnp.int32)


@pytest.mark.parametrize("block_size", [4, 16, 64])
@pytest.mark.parametrize("gqa", [1, 2, 4, 8])
def test_kernel_ragged_contexts_match_reference(gqa, block_size):
    B, L, Hkv, D = 3, 2, 2, 32
    max_blocks = -(-150 // block_size)
    NB = B * max_blocks + 1
    k_pool, v_pool = _random_pools(L, NB, block_size, Hkv, D, gqa)
    tables = _ragged_tables(B, max_blocks, NB, block_size)
    ctx = jnp.asarray([1, 77, 150], jnp.int32)
    q = jax.random.normal(jax.random.PRNGKey(9), (B, Hkv * gqa, D))
    out = paged_attention(q, k_pool, v_pool, tables, ctx, layer=1,
                          interpret=True)
    ref = paged_attention_reference(q, k_pool, v_pool, tables, ctx, layer=1)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("max_blocks,bs,splits",
                         [(4, 16, 1), (16, 8, 2), (64, 4, 4)])
def test_kernel_split_merge_is_exact(max_blocks, bs, splits):
    """The split-K partial softmaxes merge to the unsplit result; splits
    past a short context hold no key and must not perturb it."""
    from mlio_tpu.ops.paged_attention import decode_launch

    B, L, Hkv, D = 2, 1, 2, 32
    assert decode_launch(B, Hkv, max_blocks, bs)[1] == splits
    NB = B * max_blocks + 1
    k_pool, v_pool = _random_pools(L, NB, bs, Hkv, D, 3)
    tables = _ragged_tables(B, max_blocks, NB, 3)
    ctx = jnp.asarray([9, max_blocks * bs], jnp.int32)
    q = jax.random.normal(jax.random.PRNGKey(4), (B, 4, D))
    out = paged_attention(q, k_pool, v_pool, tables, ctx, layer=0,
                          interpret=True)
    ref = paged_attention_reference(q, k_pool, v_pool, tables, ctx, layer=0)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_kernel_ignores_stale_table_entries():
    """Entries past a sequence's context may hold anything (here an
    out-of-range block id); the kernel must not read them."""
    B, L, NB, bs, Hkv, D = 1, 1, 8, 16, 2, 32
    k_pool, v_pool = _random_pools(L, NB, bs, Hkv, D, 5)
    tables = jnp.asarray([[3, 5, 10_000, -7]], jnp.int32)
    ctx = jnp.asarray([20], jnp.int32)
    q = jax.random.normal(jax.random.PRNGKey(6), (B, 4, D))
    out = paged_attention(q, k_pool, v_pool, tables, ctx, layer=0,
                          interpret=True)
    ref = paged_attention_reference(q, k_pool, v_pool,
                                    jnp.asarray([[3, 5, 0, 0]], jnp.int32),
                                    ctx, layer=0)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gqa", [1, 4])
def test_kernel_int8_pools_match_reference(gqa):
    from mlio_tpu.ops.quant import quantize_kv

    B, L, NB, bs, Hkv, D = 2, 2, 20, 16, 2, 32
    k_pool, v_pool = _random_pools(L, NB, bs, Hkv, D, 7)
    kq, ks = quantize_kv(k_pool)
    vq, vs = quantize_kv(v_pool)
    tables = _ragged_tables(B, 8, NB, 7)
    ctx = jnp.asarray([33, 128], jnp.int32)
    q = jax.random.normal(jax.random.PRNGKey(8), (B, Hkv * gqa, D))
    out = paged_attention(q, kq, vq, tables, ctx, layer=1, k_scale_pool=ks,
                          v_scale_pool=vs, interpret=True)
    ref = paged_attention_reference(q, kq, vq, tables, ctx, layer=1,
                                    k_scale_pool=ks, v_scale_pool=vs)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("smax", [20, 96, 256])
def test_contiguous_cache_view(smax):
    """decode_attention views [L, B, Smax, Hkv, D] as pages (any Smax,
    down to one-token pages) and matches masked attention over the layer."""
    from mlio_tpu.ops.paged_attention import decode_attention

    L, B, Hkv, D = 2, 3, 2, 32
    ks = jax.random.split(jax.random.PRNGKey(smax), 3)
    kc = jax.random.normal(ks[0], (L, B, smax, Hkv, D))
    vc = jax.random.normal(ks[1], (L, B, smax, Hkv, D))
    q = jax.random.normal(ks[2], (B, 4, D))
    ctx = jnp.asarray([1, smax // 2, smax], jnp.int32)
    out = decode_attention(q, kc, vc, ctx, layer=1, interpret=True)
    ref = attention_reference(q[:, None], kc[1], vc[1], causal=False,
                              kv_len=ctx)[:, 0]
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("head_dim,block_size", [(24, 16), (64, 12)])
def test_kernel_rejects_non_power_of_two_blocks(head_dim, block_size):
    """Triton blocks are powers of two: other head dims or page sizes raise
    instead of taking another path."""
    k_pool, v_pool = init_kv_pools(1, 4, 2, block_size, head_dim,
                                   dtype=jnp.float32)
    q = jnp.zeros((1, 2, head_dim))
    with pytest.raises(ValueError):
        paged_attention(q, k_pool, v_pool, jnp.zeros((1, 2), jnp.int32),
                        jnp.ones((1,), jnp.int32), layer=0, interpret=True)


def test_dispatch_selects_by_impl():
    """ops.paged_decode_attention: Impl() is the gather reference, the
    flash Impl the kernel; both agree."""
    from mlio_tpu import ops
    from mlio_tpu.models import Impl

    B, L, NB, bs, Hkv, D = 2, 1, 12, 16, 2, 32
    k_pool, v_pool = _random_pools(L, NB, bs, Hkv, D, 11)
    tables = _ragged_tables(B, 4, NB, 11)
    ctx = jnp.asarray([5, 60], jnp.int32)
    q = jax.random.normal(jax.random.PRNGKey(12), (B, 4, D))
    a = ops.paged_decode_attention(q, k_pool, v_pool, tables, ctx, layer=0)
    b = ops.paged_decode_attention(
        q, k_pool, v_pool, tables, ctx, layer=0,
        impl=Impl(attention="flash", interpret=True))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_compiled_on_card(gpu, dtype):
    """The kernel compiled for the card at Llama-3-8B attention widths."""
    from mlio_tpu.ops.validation import validate_paged_attention

    r = validate_paged_attention(batch=8, heads=32, kv_heads=8, head_dim=128,
                                 block_size=16, ctx=1000, max_blocks=64,
                                 dtype=jnp.dtype(dtype))
    assert r["passed"], r
