"""Device mesh construction — the replacement for process groups.

Replaces the reference's NCCL process-group grid
(/root/reference/parallelism/parallel_utils.py:882-1002
initialize_parallel_groups, communication.py:464-500 setup_device_groups):
one `jax.sharding.Mesh` over named axes ("data", "seq", "tensor") expresses
the whole 4D layout; XLA's GSPMD inserts and schedules the collectives the
reference issues by hand on CUDA streams.

The cards of one host are joined all to all by NVLink, so axis order does
not change link speed; "tensor" stays innermost by convention. Multi-host
init parity: initialize_distributed communication.py:12-27 →
jax.distributed.initialize.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXES = ("data", "seq", "pipe", "expert", "tensor")


def make_mesh(
    data: int = 1,
    seq: int = 1,
    tensor: int = 1,
    pipe: int = 1,
    expert: int = 1,
    *,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, seq, pipe, expert, tensor) mesh over the devices.

    The product must equal the device count used (parity with the
    validation in ParallelConfig, orchestrator.py:61-120). The "expert"
    axis carries MoE expert parallelism (a capability the reference lacks,
    SURVEY.md §2.5); it sits just outside "tensor".
    """
    if devices is None:
        devices = jax.devices()
    world = data * seq * pipe * expert * tensor
    if world > len(devices):
        raise ValueError(
            f"mesh {data}x{seq}x{pipe}x{expert}x{tensor}={world} exceeds "
            f"{len(devices)} devices")
    devs = np.asarray(devices[:world]).reshape(data, seq, pipe, expert,
                                               tensor)
    return Mesh(devs, AXES)


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (parity: initialize_distributed
    communication.py:12-27). No-op on a single host."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def sharding(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))
