"""KV caches: contiguous (legacy) and paged — all static shapes.

Rebuild of the reference's cache stack (/root/reference/baseline/
inference.py:791-1302: KVCache, BlockManager, SequenceMetadata,
PagedKVCache). The central design change (SURVEY.md §7 "hard
parts"): the reference keeps dynamic Python lists of blocks; under XLA every
shape must be static, so caches here are fixed-capacity device arrays and
all variable-length state is expressed with integer tables + masks. Host-side
block accounting (free lists, refcounts, prefix sharing) stays in plain
Python — it never touches the compiled graph.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mlio_tpu.models.spec import ModelSpec


# ---------------------------------------------------------------------------
# Contiguous cache (reference: KVCache inference.py:791-1037)
# ---------------------------------------------------------------------------

def init_cache(
    spec: ModelSpec,
    batch_size: int,
    max_seq_len: Optional[int] = None,
    dtype=jnp.bfloat16,
    quant: Optional[str] = None,
) -> Dict[str, jax.Array]:
    """Allocate a contiguous cache pytree.

    Layout [L, B, S_max, H_kv, D] — layer-major so lax.scan over layers peels
    the leading axis, head_dim last (contiguous per head).

    ``quant="int8"`` allocates int8 K/V plus per-(token, head) fp32 scales
    [L, B, S_max, H_kv]; the paged decode kernel dequantizes in its inner
    loop (the INT8 KV-cache capability, BASELINE.md).
    """
    S = max_seq_len or spec.max_seq_len
    shape = (spec.num_layers, batch_size, S, spec.num_kv_heads, spec.head_size)
    if quant == "int8":
        sshape = shape[:-1]
        return {
            "k": jnp.zeros(shape, jnp.int8),
            "v": jnp.zeros(shape, jnp.int8),
            "k_scale": jnp.ones(sshape, jnp.float32),
            "v_scale": jnp.ones(sshape, jnp.float32),
            "pos": jnp.int32(0),
        }
    assert quant in (None, "none"), f"unsupported cache quant {quant}"
    return {
        "k": jnp.zeros(shape, dtype),
        "v": jnp.zeros(shape, dtype),
        "pos": jnp.int32(0),
    }


def cache_memory_bytes(spec: ModelSpec, batch_size: int, max_seq_len: int,
                       dtype=jnp.bfloat16) -> int:
    """Cache footprint (reference: KVCache.memory_stats inference.py:1010)."""
    itemsize = jnp.dtype(dtype).itemsize
    return (2 * spec.num_layers * batch_size * max_seq_len
            * spec.num_kv_heads * spec.head_size * itemsize)


# ---------------------------------------------------------------------------
# Block manager (reference: BlockManager inference.py:1045-1126)
# ---------------------------------------------------------------------------

class BlockManager:
    """Host-side physical block pool with refcounts for prefix sharing.

    The device-side pool it manages is a pair of arrays
    [num_blocks, L, block_size, H_kv, D]; this class only does integer
    accounting (free list, refcounts) and never holds device memory itself.
    """

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.free_blocks: List[int] = list(range(num_blocks))
        self.refcounts = np.zeros(num_blocks, dtype=np.int32)

    @property
    def num_free(self) -> int:
        return len(self.free_blocks)

    def allocate(self) -> int:
        if not self.free_blocks:
            raise MemoryError("out of KV-cache blocks")
        block = self.free_blocks.pop()
        self.refcounts[block] = 1
        return block

    def fork(self, block: int) -> int:
        """Share a block (copy-on-write prefix sharing)."""
        self.refcounts[block] += 1
        return block

    def free(self, block: int) -> None:
        self.refcounts[block] -= 1
        if self.refcounts[block] == 0:
            self.free_blocks.append(block)
        elif self.refcounts[block] < 0:
            raise ValueError(f"double free of block {block}")


# ---------------------------------------------------------------------------
# Paged cache (reference: PagedKVCache inference.py:1150-1302)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SequenceMetadata:
    """Per-sequence logical→physical mapping (inference.py:1129-1147)."""

    seq_id: int
    block_ids: List[int] = dataclasses.field(default_factory=list)
    length: int = 0


class PagedKVCache:
    """Paged KV cache: device arrays with static shapes + host block table.

    Device state:
      k_pool, v_pool: [num_blocks, L, block_size, H_kv, D]
      block_tables:   [max_seqs, max_blocks_per_seq] int32 (padded with 0)
      context_lens:   [max_seqs] int32
    The pools are written by the reshape_and_cache kernel and read by the
    paged-attention decode kernel (mlio_tpu.ops.paged_attention).
    """

    def __init__(
        self,
        spec: ModelSpec,
        num_blocks: int,
        block_size: int = 16,
        max_seqs: int = 64,
        max_seq_len: Optional[int] = None,
        dtype=jnp.bfloat16,
    ):
        self.spec = spec
        self.block_size = block_size
        self.max_seqs = max_seqs
        self.max_seq_len = max_seq_len or spec.max_seq_len
        self.max_blocks_per_seq = -(-self.max_seq_len // block_size)
        self.dtype = dtype
        pool_shape = (num_blocks, spec.num_layers, block_size,
                      spec.num_kv_heads, spec.head_size)
        self.k_pool = jnp.zeros(pool_shape, dtype)
        self.v_pool = jnp.zeros(pool_shape, dtype)
        self.manager = BlockManager(num_blocks, block_size)
        self.sequences: Dict[int, SequenceMetadata] = {}
        # Prefix cache: hash of token prefix -> block ids (reference stubs
        # this with a TODO at inference.py:1180,1205; implemented here).
        self._prefix_cache: Dict[Tuple[int, ...], List[int]] = {}

    # -- host-side accounting ------------------------------------------------

    def allocate_sequence(self, seq_id: int, prompt_len: int) -> SequenceMetadata:
        if seq_id in self.sequences:
            raise ValueError(f"sequence {seq_id} already allocated")
        num_blocks = -(-prompt_len // self.block_size) if prompt_len else 0
        meta = SequenceMetadata(seq_id=seq_id)
        for _ in range(num_blocks):
            meta.block_ids.append(self.manager.allocate())
        meta.length = prompt_len
        self.sequences[seq_id] = meta
        return meta

    def append_token(self, seq_id: int) -> None:
        """Account for one generated token, growing the block list on a
        block boundary (inference.py:1216-1260)."""
        meta = self.sequences[seq_id]
        capacity = len(meta.block_ids) * self.block_size
        if meta.length == capacity:
            meta.block_ids.append(self.manager.allocate())
        meta.length += 1

    def free_sequence(self, seq_id: int) -> None:
        meta = self.sequences.pop(seq_id)
        for b in meta.block_ids:
            self.manager.free(b)

    def fork_sequence(self, src_id: int, dst_id: int) -> None:
        """Share all blocks of src with dst (prefix sharing / beam search)."""
        src = self.sequences[src_id]
        dst = SequenceMetadata(seq_id=dst_id,
                               block_ids=[self.manager.fork(b) for b in src.block_ids],
                               length=src.length)
        self.sequences[dst_id] = dst

    # -- device-side tables --------------------------------------------------

    def block_table_array(self, seq_ids: List[int]) -> jax.Array:
        """Dense [len(seq_ids), max_blocks_per_seq] int32 table for kernels."""
        table = np.zeros((len(seq_ids), self.max_blocks_per_seq), dtype=np.int32)
        for row, sid in enumerate(seq_ids):
            ids = self.sequences[sid].block_ids
            table[row, : len(ids)] = ids
        return jnp.asarray(table)

    def context_lens_array(self, seq_ids: List[int]) -> jax.Array:
        return jnp.asarray([self.sequences[s].length for s in seq_ids], dtype=jnp.int32)

    def memory_stats(self) -> Dict[str, float]:
        """(reference: PagedKVCache.memory_stats inference.py:1280-1302)."""
        itemsize = jnp.dtype(self.dtype).itemsize
        block_bytes = (2 * self.spec.num_layers * self.block_size
                       * self.spec.num_kv_heads * self.spec.head_size * itemsize)
        used = self.manager.num_blocks - self.manager.num_free
        return {
            "num_blocks": self.manager.num_blocks,
            "used_blocks": used,
            "free_blocks": self.manager.num_free,
            "block_bytes": block_bytes,
            "used_bytes": used * block_bytes,
            "total_bytes": self.manager.num_blocks * block_bytes,
            "utilization": used / max(1, self.manager.num_blocks),
        }


def calculate_num_blocks(
    spec: ModelSpec,
    free_hbm_bytes: int,
    block_size: int = 16,
    dtype=jnp.bfloat16,
    memory_fraction: float = 0.9,
) -> int:
    """Block budget from available memory
    (reference: _calculate_num_gpu_blocks inference.py:1448-1499)."""
    itemsize = jnp.dtype(dtype).itemsize
    block_bytes = (2 * spec.num_layers * block_size * spec.num_kv_heads
                   * spec.head_size * itemsize)
    return max(1, int(free_hbm_bytes * memory_fraction) // block_bytes)
