"""Autoregressive generation: prefill + fully-jitted decode loop.

Rebuild of the reference's generation path (verify_baseline.py:247-304 greedy
smoke test; TransformerInferenceRunner decode, baseline/inference.py:1306+):
the whole decode loop is one ``lax.scan`` inside jit — no per-token Python
dispatch, no host↔device sync until the final tokens come back.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from mlio_tpu.models.spec import ModelSpec
from mlio_tpu.models.transformer import Impl, forward
from mlio_tpu.runtime.kv_cache import init_cache
from mlio_tpu.runtime import sampling


@functools.partial(
    jax.jit,
    static_argnames=("spec", "impl", "max_new_tokens", "cache_len", "method",
                     "cache_quant"),
)
def _generate_impl(
    params,
    spec: ModelSpec,
    input_ids: jax.Array,
    rng: jax.Array,
    *,
    impl: Impl,
    max_new_tokens: int,
    cache_len: int,
    method: sampling.SamplingMethod,
    cache_quant=None,
) -> jax.Array:
    B, S = input_ids.shape
    cache = init_cache(spec, B, cache_len,
                       dtype=params["tok_embed"].dtype, quant=cache_quant)

    # Prefill: score the whole prompt once, take the last position's logits.
    logits, cache = forward(params, spec, input_ids, impl=impl, cache=cache)
    next_token = sampling.sample(logits[:, -1, :], rng, method)  # [B]

    def step(carry, rng_step):
        cache, token = carry
        logits, cache = forward(params, spec, token[:, None], impl=impl,
                                cache=cache)
        new_token = sampling.sample(logits[:, -1, :], rng_step, method)
        return (cache, new_token), token

    rngs = jax.random.split(rng, max_new_tokens)
    (cache, last_token), tokens = jax.lax.scan(
        step, (cache, next_token), rngs[: max_new_tokens - 1], length=max_new_tokens - 1
    ) if max_new_tokens > 1 else ((cache, next_token), jnp.zeros((0, B), jnp.int32))
    # tokens: [T-1, B] are all but the last; append it.
    all_new = jnp.concatenate([tokens, last_token[None]], axis=0)  # [T, B]
    return jnp.concatenate([input_ids, all_new.T.astype(input_ids.dtype)], axis=1)


def generate(
    params,
    spec: ModelSpec,
    input_ids: jax.Array,
    *,
    max_new_tokens: int = 16,
    impl: Impl = Impl(),
    method: Optional[sampling.SamplingMethod] = None,
    rng: Optional[jax.Array] = None,
    cache_len: Optional[int] = None,
    cache_quant: Optional[str] = None,
) -> jax.Array:
    """Generate ``max_new_tokens`` tokens. Returns [B, S + T] token ids."""
    if method is None:
        method = sampling.SamplingMethod()  # greedy
    if rng is None:
        rng = jax.random.PRNGKey(0)
    B, S = input_ids.shape
    if cache_len is None:
        cache_len = min(spec.max_seq_len, S + max_new_tokens)
    assert S + max_new_tokens <= cache_len, "cache too small for requested generation"
    return _generate_impl(params, spec, input_ids, rng, impl=impl,
                          max_new_tokens=max_new_tokens, cache_len=cache_len,
                          method=method, cache_quant=cache_quant)


def greedy_generate(params, spec, input_ids, *, max_new_tokens=16,
                    impl: Impl = Impl()):
    """Greedy decode (parity: verify_baseline.py:247-304)."""
    return generate(params, spec, input_ids, max_new_tokens=max_new_tokens,
                    impl=impl, method=sampling.SamplingMethod(temperature=0.0))
