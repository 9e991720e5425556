"""Mixture-of-Experts MLP: routing, dropless grouped matmul, EP dispatch.

The reference framework has **no MoE support and no expert parallelism**
(SURVEY.md §2.5: "EP: absent") — this module is a capability addition that
completes the tp/pp/dp/sp/**ep** parallel-dimension set.

Three execution methods behind one contract:

``dense``
    Every expert runs on every token; outputs are combined with the routing
    weights. Exact, dropless, E/top_k x FLOPs waste — the correctness oracle
    and the small-model path.

``ragged``
    Dropless megablocks-style grouped matmul: replicate each token top_k
    times, sort the copies by expert id, run one ``jax.lax.ragged_dot`` per
    projection (a grouped matmul that skips empty groups),
    unsort, and combine. Exact (bitwise-equal token sets, no capacity drops)
    with top_k/E x the dense-method FLOPs. The default on a single shard.

``dispatch``
    GShard/Switch capacity-based one-hot dispatch expressed as einsums
    (`dispatch [T,E,C]`). Every op is a static-shape einsum, so GSPMD can
    shard the expert axis over an "expert" mesh axis and insert the
    all-to-alls — this is the **expert-parallel** path. Tokens routed beyond
    ``capacity_factor * top_k * T / E`` per expert are dropped (their combine
    weight is 0), matching the GShard semantics; capacity_factor >= E/top_k
    makes it exact.

Routing follows the Mixtral convention: softmax over ALL expert logits,
take top-k, renormalize the kept weights (HF MixtralSparseMoeBlock).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax


def _dequant(w, dtype):
    from mlio_tpu.ops.quant import QTensor, dequantize

    if isinstance(w, QTensor):
        # Per-expert per-output-channel scales; XLA fuses the int->float
        # convert + scale into the consuming matmul.
        return dequantize(w, dtype)
    return w.astype(dtype) if w is not None else None


def router_topk(x: jax.Array, w_router: jax.Array, top_k: int,
                ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Route tokens: softmax over all experts, keep top-k, renormalize.

    x: [T, H]; w_router: [H, E]. Returns (weights [T, k] fp32,
    expert_idx [T, k] int32, full_probs [T, E] fp32 — for aux losses /
    load-balance stats).
    """
    logits = x.astype(jnp.float32) @ w_router.astype(jnp.float32)  # [T, E]
    probs = jax.nn.softmax(logits, axis=-1)
    weights, idx = lax.top_k(probs, top_k)  # [T, k]
    weights = weights / jnp.sum(weights, axis=-1, keepdims=True)
    return weights, idx.astype(jnp.int32), probs


def _activate(up, gate, activation):
    from mlio_tpu.ops import activate

    return activate(up, gate, activation)


def _expert_mlp_batched(xe, w_gate, w_up, w_down, activation, dtype):
    """Per-expert MLP over expert-major batches xe [E, C, H] -> [E, C, H]."""
    up = jnp.einsum("ech,ehi->eci", xe, w_up)
    gate = (jnp.einsum("ech,ehi->eci", xe, w_gate)
            if w_gate is not None else None)
    if gate is not None:
        h = _activate(up, gate, activation)
    else:
        h = _activate(up, None, activation)
    return jnp.einsum("eci,eih->ech", h.astype(dtype), w_down)


def moe_mlp_dense(x, w_router, w_gate, w_up, w_down, *, top_k: int,
                  activation: str = "swiglu") -> jax.Array:
    """Oracle: run all experts on all tokens, combine by routing weights.

    x: [T, H]; expert weights [E, H, I] / [E, I, H].
    """
    dtype = x.dtype
    w_up = _dequant(w_up, dtype)
    w_gate = _dequant(w_gate, dtype)
    w_down = _dequant(w_down, dtype)
    weights, idx, _ = router_topk(x, w_router, top_k)
    ye = _expert_mlp_batched(
        jnp.broadcast_to(x[None], (w_up.shape[0],) + x.shape),
        w_gate, w_up, w_down, activation, dtype)
    # combine: scatter top-k weights into a dense [T, E] matrix
    E = w_up.shape[0]
    comb = jnp.zeros((x.shape[0], E), jnp.float32)
    comb = jax.vmap(lambda c, i, w: c.at[i].add(w))(comb, idx, weights)
    return jnp.einsum("ceh,ce->ch", ye.transpose(1, 0, 2).astype(jnp.float32),
                      comb).astype(dtype)


def moe_mlp_ragged(x, w_router, w_gate, w_up, w_down, *, top_k: int,
                   activation: str = "swiglu") -> jax.Array:
    """Dropless grouped-matmul MoE (megablocks pattern) via lax.ragged_dot.

    Token copies are sorted by expert so each expert's rows are contiguous;
    ragged_dot([T*k, H], [E, H, I], group_sizes) runs one grouped
    matmul. No capacity, no drops.
    """
    dtype = x.dtype
    w_up = _dequant(w_up, dtype)
    w_gate = _dequant(w_gate, dtype)
    w_down = _dequant(w_down, dtype)
    T, H = x.shape
    E = w_up.shape[0]
    weights, idx, _ = router_topk(x, w_router, top_k)

    flat_e = idx.reshape(-1)  # [T*k] expert of each copy
    order = jnp.argsort(flat_e, stable=True)  # copies grouped by expert
    inv = jnp.argsort(order, stable=True)
    xs = jnp.repeat(x, top_k, axis=0)[order]  # [T*k, H] sorted
    group_sizes = jnp.bincount(flat_e, length=E).astype(jnp.int32)

    up = lax.ragged_dot(xs, w_up, group_sizes)
    gate = lax.ragged_dot(xs, w_gate, group_sizes) if w_gate is not None else None
    h = _activate(up, gate, activation).astype(dtype)
    ys = lax.ragged_dot(h, w_down, group_sizes)  # [T*k, H]

    y = ys[inv].reshape(T, top_k, H).astype(jnp.float32)
    return jnp.einsum("tkh,tk->th", y, weights).astype(dtype)


def moe_mlp_dispatch(x, w_router, w_gate, w_up, w_down, *, top_k: int,
                     activation: str = "swiglu",
                     capacity_factor: float = 2.0,
                     capacity: Optional[int] = None) -> jax.Array:
    """GShard capacity-based dispatch — the expert-parallel (EP) path.

    All data movement is einsums against a one-hot dispatch tensor
    [T, E, C]; with tokens sharded on ("data","seq") and experts sharded on
    "expert", GSPMD lowers the dispatch/combine einsums to all-to-alls over
    the mesh (SURVEY.md §2.5's missing EP dimension). Overflow tokens beyond
    each expert's capacity are dropped (combine weight 0) — GShard
    semantics; with capacity >= top_k*T the method is exact.
    """
    dtype = x.dtype
    w_up = _dequant(w_up, dtype)
    w_gate = _dequant(w_gate, dtype)
    w_down = _dequant(w_down, dtype)
    T, H = x.shape
    E = w_up.shape[0]
    if capacity is None:
        capacity = int(capacity_factor * top_k * T / E) + 1
        capacity = -(-capacity // 8) * 8  # sublane-align the expert batches
    C = min(capacity, top_k * T)

    weights, idx, _ = router_topk(x, w_router, top_k)

    # Position of each (token, k) copy within its expert's queue: rank the
    # copies in (k, token) priority order — top-1 assignments fill first,
    # matching GShard's drop policy.
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.int32)  # [T, k, E]
    flat = onehot.transpose(1, 0, 2).reshape(top_k * T, E)  # k-major
    pos_flat = jnp.cumsum(flat, axis=0) - flat  # [k*T, E] position if routed
    pos = pos_flat.reshape(top_k, T, E).transpose(1, 0, 2)  # [T, k, E]
    pos_k = jnp.sum(pos * onehot, axis=-1)  # [T, k] queue slot
    keep = pos_k < C  # dropped copies get no dispatch slot

    # dispatch[t, e, c] = 1 iff some copy of token t goes to slot c of e
    slot = jax.nn.one_hot(jnp.where(keep, pos_k, C), C, dtype=dtype)  # [T,k,C]
    disp = jnp.einsum("tke,tkc->tec", onehot.astype(dtype), slot)
    comb = jnp.einsum("tke,tkc,tk->tec", onehot.astype(jnp.float32),
                      slot.astype(jnp.float32),
                      weights * keep.astype(jnp.float32))

    xe = jnp.einsum("tec,th->ech", disp, x)  # all-to-all under EP
    ye = _expert_mlp_batched(xe, w_gate, w_up, w_down, activation, dtype)
    return jnp.einsum("tec,ech->th", comb,
                      ye.astype(jnp.float32)).astype(dtype)


def moe_mlp(x, w_router, w_gate, w_up, w_down, *, top_k: int,
            activation: str = "swiglu", method: str = "ragged",
            capacity_factor: float = 2.0) -> jax.Array:
    """MoE MLP over x [B, S, H] (or [T, H]); see module docstring."""
    squeeze = x.ndim == 3
    if squeeze:
        B, S, H = x.shape
        x2 = x.reshape(B * S, H)
    else:
        x2 = x
    fn = {"dense": moe_mlp_dense, "ragged": moe_mlp_ragged,
          "dispatch": partial(moe_mlp_dispatch,
                              capacity_factor=capacity_factor)}[method]
    y = fn(x2, w_router, w_gate, w_up, w_down, top_k=top_k,
           activation=activation)
    return y.reshape(B, S, H) if squeeze else y


def load_balance_loss(probs: jax.Array, idx: jax.Array, num_experts: int,
                      ) -> jax.Array:
    """Switch-Transformer auxiliary load-balance loss (for fine-tuning /
    router health metrics): E * sum_e f_e * P_e, where f_e is the fraction
    of tokens whose top-1 choice is e and P_e the mean router prob."""
    top1 = idx[..., 0]
    f = jnp.mean(jax.nn.one_hot(top1, num_experts, dtype=jnp.float32), axis=0)
    p = jnp.mean(probs, axis=0)
    return num_experts * jnp.sum(f * p)
