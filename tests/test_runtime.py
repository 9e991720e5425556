"""Runtime tests: KV-cache consistency, block accounting, sampling.

Covers the gaps SURVEY.md §4 calls out in the reference (no unit tests for
KV-cache block accounting) plus decode-vs-prefill equivalence.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mlio_tpu.models import ModelSpec, Impl, forward, get_spec, init_params
from mlio_tpu.runtime import (
    BlockManager,
    PagedKVCache,
    SamplingMethod,
    calculate_num_blocks,
    init_cache,
    sample,
)


@pytest.fixture(scope="module", params=["gpt2-tiny", "llama-tiny"])
def model(request):
    spec = get_spec(request.param)
    params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    return spec, params


def test_cached_decode_matches_full_forward(model):
    """Prefill+decode through the cache must equal one dense forward."""
    spec, params = model
    ids = jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0, spec.vocab_size)

    full_logits, _ = forward(params, spec, ids)

    cache = init_cache(spec, 2, 32, dtype=jnp.float32)
    _, cache = forward(params, spec, ids[:, :7], cache=cache)
    step_logits = []
    for t in range(7, 12):
        logits, cache = forward(params, spec, ids[:, t : t + 1], cache=cache)
        step_logits.append(logits[:, 0])
    stepped = jnp.stack(step_logits, axis=1)
    np.testing.assert_allclose(
        np.asarray(stepped), np.asarray(full_logits[:, 7:12]), rtol=1e-4, atol=1e-4
    )


def test_block_manager_refcounts():
    mgr = BlockManager(num_blocks=4, block_size=16)
    a = mgr.allocate()
    b = mgr.allocate()
    assert mgr.num_free == 2
    mgr.fork(a)
    mgr.free(a)
    assert mgr.num_free == 2  # still referenced once
    mgr.free(a)
    assert mgr.num_free == 3
    mgr.free(b)
    assert mgr.num_free == 4
    with pytest.raises(ValueError):
        mgr.free(b)


def test_block_manager_exhaustion():
    mgr = BlockManager(num_blocks=2, block_size=16)
    mgr.allocate()
    mgr.allocate()
    with pytest.raises(MemoryError):
        mgr.allocate()


def test_paged_cache_accounting():
    spec = get_spec("gpt2-tiny")
    cache = PagedKVCache(spec, num_blocks=16, block_size=4, max_seqs=4, max_seq_len=32)
    cache.allocate_sequence(0, prompt_len=6)  # 2 blocks
    assert cache.manager.num_free == 14
    # 6 tokens fill blocks of capacity 8; two appends fit, third allocates
    cache.append_token(0)
    cache.append_token(0)
    assert cache.manager.num_free == 14
    cache.append_token(0)
    assert cache.manager.num_free == 13
    table = np.asarray(cache.block_table_array([0]))
    assert table.shape == (1, 8)
    assert (table[0, :3] > 0).sum() >= 2  # 3 allocated blocks (ids may include 0? no: pool ids)
    lens = np.asarray(cache.context_lens_array([0]))
    assert lens[0] == 9
    cache.fork_sequence(0, 1)
    assert cache.manager.num_free == 13  # shared, no new blocks
    cache.free_sequence(0)
    assert cache.manager.num_free == 13  # blocks still referenced by seq 1
    cache.free_sequence(1)
    assert cache.manager.num_free == 16
    stats = cache.memory_stats()
    assert stats["used_blocks"] == 0


def test_calculate_num_blocks():
    spec = get_spec("gpt2-tiny")
    n = calculate_num_blocks(spec, free_hbm_bytes=1 << 20, block_size=4,
                             dtype=jnp.bfloat16)
    # block bytes = 2 (k,v) * 2 layers * 4 slots * 4 heads * 16 dim * 2B = 2048
    assert n == int((1 << 20) * 0.9) // 2048


def test_sampling_greedy_and_topk():
    logits = jnp.asarray([[0.0, 5.0, 1.0, 2.0]])
    rng = jax.random.PRNGKey(0)
    assert int(sample(logits, rng, SamplingMethod(temperature=0.0))[0]) == 1
    # top_k=1 must always return the argmax regardless of temperature
    for seed in range(5):
        tok = sample(logits, jax.random.PRNGKey(seed),
                     SamplingMethod(temperature=1.0, top_k=1))
        assert int(tok[0]) == 1
    # top_p tiny must also collapse to argmax
    for seed in range(5):
        tok = sample(logits, jax.random.PRNGKey(seed),
                     SamplingMethod(temperature=1.0, top_p=0.01))
        assert int(tok[0]) == 1


def test_optimized_decode_path_matches_dense(model):
    """The S==1 carry-cache + paged-view decode path (Impl flash) must match
    the generic dense cached decode."""
    spec, params = model
    ids = jax.random.randint(jax.random.PRNGKey(5), (2, 10), 0, spec.vocab_size)
    fast = Impl(attention="flash", interpret=True)

    cache_a = init_cache(spec, 2, 32, dtype=jnp.float32)
    cache_b = init_cache(spec, 2, 32, dtype=jnp.float32)
    la, cache_a = forward(params, spec, ids[:, :6], cache=cache_a)
    lb, cache_b = forward(params, spec, ids[:, :6], cache=cache_b, impl=fast)
    for t in range(6, 10):
        sa, cache_a = forward(params, spec, ids[:, t:t+1], cache=cache_a)
        sb, cache_b = forward(params, spec, ids[:, t:t+1], cache=cache_b,
                              impl=fast)
        np.testing.assert_allclose(np.asarray(sa), np.asarray(sb),
                                   rtol=2e-3, atol=2e-3)
    # caches agree on the valid prefix
    np.testing.assert_allclose(np.asarray(cache_a["k"][:, :, :10]),
                               np.asarray(cache_b["k"][:, :, :10]),
                               rtol=1e-4, atol=1e-4)
