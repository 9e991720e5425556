"""Tensor-parallel sharding rules (Megatron pattern as NamedShardings).

Replaces the reference's module-surgery TP layer
(/root/reference/parallelism/tensor_parallel.py: ColumnParallelLinear :88,
RowParallelLinear :207, TensorParallelMLP :330, TensorParallelAttention :403,
ModelParallelConverter :617): instead of swapping nn.Modules and slicing
weights per rank, we annotate the parameter pytree with PartitionSpecs and
let GSPMD partition the same functional forward. Column-parallel = shard the
output dim, row-parallel = shard the contracting dim (XLA inserts the
all-reduce the reference issues manually at tensor_parallel.py:300-326).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mlio_tpu.models.spec import ModelSpec


def param_specs(spec: ModelSpec) -> Dict[str, Any]:
    """PartitionSpec pytree matching models.transformer's parameter layout.

    Megatron mapping (tensor_parallel.py:330-400):
      wq/wk/wv, w_up, w_gate  -> column parallel: shard output dim on "tensor"
      wo, w_down              -> row parallel: shard input dim on "tensor"
      embeddings              -> shard vocab dim (output-embedding all-gather
                                 is deferred to the logits matmul)
      norms / biases of row-parallel outputs -> replicated
    Leading stacked-layer axis is never sharded.
    """
    col = P(None, None, "tensor")   # [L, in, out] shard out
    row = P(None, "tensor", None)   # [L, in, out] shard in
    bias_col = P(None, "tensor")    # [L, out]
    rep2 = P(None, None)
    blocks = {
        "ln1_scale": rep2, "ln1_bias": rep2,
        "wq": col, "bq": bias_col,
        "wk": col, "bk": bias_col,
        "wv": col, "bv": bias_col,
        "wo": row, "bo": rep2,
        "ln2_scale": rep2, "ln2_bias": rep2,
        "w_up": col, "b_up": bias_col,
        "w_gate": col, "b_gate": bias_col,
        "w_down": row, "b_down": rep2,
        # fused-projection layout (runtime.quantization.fuse_projections):
        # concatenated output dims are still column parallel — GSPMD keeps
        # the logical [.., q|k|v] view, so the forward's lane-offset splits
        # stay correct on each shard.
        "wqkv": col, "bqkv": bias_col,
        "w_upgate": col, "b_upgate": bias_col,
        # MoE (capability addition — reference has no EP, SURVEY §2.5):
        # router stays replicated (every token needs all E logits); expert
        # weights shard the expert dim on "expert" and keep the Megatron
        # column/row pattern on "tensor" within each expert.
        "router": rep2,
        "moe_up": P(None, "expert", None, "tensor"),
        "moe_gate": P(None, "expert", None, "tensor"),
        "moe_down": P(None, "expert", "tensor", None),
    }
    return {
        "tok_embed": P("tensor", None),
        "pos_embed": P(None, None),
        "blocks": blocks,
        "final_scale": P(None),
        "final_bias": P(None),
        "lm_head": P(None, "tensor"),
        "lm_head_bias": P("tensor"),
    }


def _prune_to(params, specs):
    """Match the spec tree to the params tree (drop specs for None leaves;
    keys without a rule fall back to replicated)."""
    if isinstance(params, dict):
        return {k: _prune_to(params[k],
                             specs.get(k, P()) if isinstance(specs, dict)
                             else P())
                for k in params}
    return None if params is None else specs


def shard_params(params, spec: ModelSpec, mesh: Mesh):
    """Place a parameter pytree onto the mesh with TP shardings.

    Quantized weights (:class:`~mlio_tpu.ops.quant.QTensor` leaves, e.g. the
    70B-class FP8/INT8 deployment configs) shard like their dense
    counterparts: the payload [L, K, N] takes the weight's PartitionSpec and
    the per-output-channel scale [L, N] follows the output dim — sharded
    under column parallelism, replicated under row parallelism (where N is
    the unsharded output dim). The reference shards quantized layers by
    module surgery (tensor_parallel.py:88-330); here the same placement is a
    pair of device_puts and GSPMD partitions the dequant-matmul.
    """
    from mlio_tpu.ops.quant import QTensor

    specs = _prune_to(params, param_specs(spec))

    def leaf(x, s):
        if x is None:
            return None
        if isinstance(x, QTensor):
            # weight spec covers [..., K, N]; the per-output-channel scale
            # drops the contracting axis K ([L, N] for dense weights,
            # [L, E, N] for MoE expert stacks).
            n = x.q.ndim
            ax = [s[i] if i < len(s) else None for i in range(n)]
            q = jax.device_put(x.q, NamedSharding(mesh, s))
            sc = jax.device_put(
                x.scale,
                NamedSharding(mesh, P(*(ax[:n - 2] + [ax[n - 1]]))))
            return QTensor(q, sc, x.fmt)
        return jax.device_put(x, NamedSharding(mesh, s))

    return jax.tree_util.tree_map(
        leaf, params, specs,
        is_leaf=lambda x: x is None or isinstance(x, QTensor))


def init_sharded_params(spec: ModelSpec, key: jax.Array, dtype,
                        mesh: Optional[Mesh] = None):
    """Random-init parameters under jit, every leaf created where it lives.

    With a ``mesh`` each leaf comes out sharded by :func:`param_specs`, so a
    model larger than one card never lands whole on the first one; without
    one, on the default device. Either way no float32 copy of the weights is
    materialized."""
    from mlio_tpu.models.transformer import init_params

    fn = functools.partial(init_params, spec, dtype=dtype)
    if mesh is None:
        return jax.jit(fn)(key)
    shapes = jax.eval_shape(fn, key)
    specs = _prune_to(shapes, param_specs(spec))
    shardings = jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, P))
    return jax.jit(fn, out_shardings=shardings)(key)


def data_specs() -> Dict[str, Any]:
    """Input/activation sharding: batch over "data", sequence over "seq"."""
    return {
        "input_ids": P("data", "seq"),
        "hidden": P("data", "seq", None),
        "cache": P(None, "data", None, "tensor", None),  # [L,B,S,Hkv,D]
    }


def validate_tp_divisibility(spec: ModelSpec, tp: int, ep: int = 1) -> None:
    """(parity: divisibility checks parallel_utils.py:11-40)."""
    assert spec.num_heads % tp == 0, (
        f"num_heads {spec.num_heads} not divisible by tp={tp}")
    assert spec.num_kv_heads % tp == 0 or tp % spec.num_kv_heads == 0, (
        f"kv heads {spec.num_kv_heads} incompatible with tp={tp}")
    assert spec.intermediate_size % tp == 0, (
        f"intermediate {spec.intermediate_size} not divisible by tp={tp}")
    if ep > 1:
        assert spec.num_experts and spec.num_experts % ep == 0, (
            f"num_experts {spec.num_experts} not divisible by ep={ep}")
