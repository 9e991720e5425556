"""The decode paths that replaced the whole-stack decode kernels, against
full-forward scoring.

* XLA decode in ``generate`` (``Impl()``): the layer scan with the cache in
  the carry, over every model family, with and without an int8 cache, at two
  batch sizes.
* The Pallas-Triton paged decode kernel inside ``generate``
  (``Impl(attention="flash")`` in interpret mode) over the same families.
* The continuous-batching engine on both paths against dense greedy
  generation.

Decode-path logits are compared with an uncached forward over the same
sequence (teacher forcing), so the check does not depend on argmax ties.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mlio_tpu.models import Impl, forward, get_spec, init_params
from mlio_tpu.runtime import greedy_generate, init_cache
from mlio_tpu.runtime.engine import InferenceEngine
from mlio_tpu.runtime.sampling import SamplingMethod

FAMILIES = ["gpt2-tiny", "llama-tiny", "moe-tiny", "neox-tiny"]
KERNEL = Impl(attention="flash", interpret=True)


def _params(name):
    spec = get_spec(name)
    return spec, init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32)


def _decode_vs_full(spec, params, impl, batch, cache_quant, prompt=6, new=5):
    """Max |cached decode logits - uncached forward logits| over the
    ``new`` teacher-forced steps after a ``prompt``-token prefill."""
    ids = jax.random.randint(jax.random.PRNGKey(batch), (batch, prompt + new),
                             0, spec.vocab_size)
    cache = init_cache(spec, batch, prompt + new, dtype=jnp.float32,
                       quant=cache_quant)

    @jax.jit
    def cached(params, ids, cache):
        logits, cache = forward(params, spec, ids[:, :prompt], impl=impl,
                                cache=cache)

        def step(cache, tok):
            out, cache = forward(params, spec, tok[:, None], impl=impl,
                                 cache=cache)
            return cache, out[:, 0]

        _, steps = jax.lax.scan(step, cache, ids[:, prompt:].T)
        return logits[:, -1], steps

    first, steps = cached(params, ids, cache)
    full, _ = forward(params, spec, ids)
    want = full[:, prompt - 1:prompt + new]                 # [B, new+1, V]
    got = jnp.concatenate([first[:, None], steps.swapaxes(0, 1)], axis=1)
    return float(jnp.max(jnp.abs(got[:, :new] - want[:, :new])))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("cache_quant", [None, "int8"])
@pytest.mark.parametrize("name", FAMILIES)
def test_xla_decode_matches_full_forward(name, cache_quant, batch):
    spec, params = _params(name)
    err = _decode_vs_full(spec, params, Impl(), batch, cache_quant)
    # f32 cache: summation order only; int8 cache: per-(token, head) int8
    # rounding of K/V (1/254 of each row's max)
    assert err < (1e-4 if cache_quant is None else 5e-2), err


@pytest.mark.parametrize("cache_quant", [None, "int8"])
@pytest.mark.parametrize("name", FAMILIES)
def test_kernel_decode_matches_full_forward(name, cache_quant):
    spec, params = _params(name)
    err = _decode_vs_full(spec, params, KERNEL, 2, cache_quant)
    assert err < (1e-4 if cache_quant is None else 5e-2), err


@pytest.mark.parametrize("impl", [Impl(), KERNEL], ids=["xla", "kernel"])
@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny", "neox-tiny"])
def test_engine_paths_match_dense_generate(name, impl):
    """Paged engine (XLA gather path or the paged kernel) greedy output ==
    dense-cache greedy generation, with per-request token budgets."""
    spec, params = _params(name)
    prompts = [[5, 9, 2, 7], [11, 3], [1, 2, 3, 4, 5, 6, 7]]
    budgets = [6, 3, 5]
    engine = InferenceEngine(spec, params, max_batch=2, max_seq_len=64,
                             dtype=jnp.float32, impl=impl,
                             method=SamplingMethod(temperature=0.0))
    outs = engine.run(prompts, max_new_tokens=budgets)
    for p, out, n in zip(prompts, outs, budgets):
        dense = greedy_generate(params, spec, jnp.asarray([p]),
                                max_new_tokens=n)
        assert out == np.asarray(dense)[0, len(p):].tolist(), (p, out)
    # time to first token was stamped for every request
    assert all(r.first_token_at is not None
               and r.first_token_at >= r.submitted_at
               for r in engine.finished)
