"""Multi-process scale-out: process-group bootstrap and the global mesh.

Counterpart of ``bevy_ggrs_tpu/parallel/multihost.py``. The reference's
distributed backend is peer-to-peer UDP between full replicas; the scale
axes this framework adds (speculative branches, sharded entity worlds) run
on collectives instead. The port runs one process per device under
``torch.distributed``: NCCL between GPUs, gloo on the CPU when the caller
names it.

The layout rule is the JAX package's: :func:`global_branch_mesh` puts the
branch axis outermost, so each process owns a contiguous branch block and
a rollout needs no collective; only a commit of a branch another process
owns crosses processes (one broadcast of the branch's ring and state).

Host-side session I/O stays replicated: every process runs the same
session protocol on the same inputs (determinism keeps the replicas
consistent), so every process issues the same collectives in the same
order.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from bevy_ggrs_tpu_torch.parallel.sharding import branch_mesh, default_device_type


def _init_method(coordinator_address: Optional[str]) -> str:
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[str] = None,
    backend: Optional[str] = None,
) -> Tuple[int, int]:
    """Join the process group and return ``(process_id, num_processes)``.

    ``coordinator_address`` is ``host:port`` (``tcp://`` is added) or a
    full ``init_method`` URL (``file://...``); without it the group reads
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE`` from the
    environment, and with none of those set this is the single process
    ``(0, 1)``. The backend is NCCL when ``device`` is ``cuda`` (the
    default, raising without a GPU) and gloo when it is ``cpu``.
    ``num_processes <= 1`` is a no-op returning ``(0, 1)``, so a program
    can call this unconditionally. Raises when more than one process was asked for and
    the group ended up with one. ``backend`` overrides the choice: several
    processes sharing one GPU take gloo (NCCL refuses two ranks on one
    device)."""
    if num_processes is not None and num_processes <= 1:
        return 0, 1
    if dist.is_initialized():
        # Already joined (a launcher or another library): report the
        # topology the group has.
        return dist.get_rank(), dist.get_world_size()
    explicit = coordinator_address is not None or (
        num_processes is not None and num_processes > 1)
    if not explicit and "MASTER_ADDR" not in os.environ:
        return 0, 1
    if backend is None:
        backend = "nccl" if (device or default_device_type()) == "cuda" else "gloo"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            **kwargs)
    if explicit and dist.get_world_size() <= 1 and (num_processes or 2) > 1:
        # A silent (0, 1) would turn the job into disconnected replicas
        # with no error at the cause.
        raise RuntimeError(f"asked for {num_processes} processes, the group has "
                           f"{dist.get_world_size()}")
    return dist.get_rank(), dist.get_world_size()


def global_branch_mesh(
    entity_shards: int = 1,
    branch_axis: str = "branch",
    entity_axis: str = "entity",
    device_type: Optional[str] = None,
):
    """A ``[branch, entity]`` mesh over every process's device, the branch
    axis outermost so each process owns a contiguous branch block.
    ``device_type`` as in :func:`~bevy_ggrs_tpu_torch.parallel.sharding.
    branch_mesh`: without a group, ``cuda`` unless ``"cpu"`` is named."""
    return branch_mesh(None, entity_shards, branch_axis, entity_axis, device_type)


def _rank_and_count() -> Tuple[int, int]:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_branch_slice(num_branches: int) -> Tuple[int, int]:
    """The ``[start, stop)`` branch block this process rolls out when the
    branch axis spans a :func:`global_branch_mesh`. Branch counts must
    divide evenly over the processes."""
    index, count = _rank_and_count()
    if num_branches % count:
        raise ValueError(
            f"num_branches={num_branches} not divisible by "
            f"process_count={count}"
        )
    per = num_branches // count
    start = index * per
    return start, start + per


def process_topology() -> dict:
    """This process's view of the cluster, in the JAX package's keys."""
    index, count = _rank_and_count()
    local = ([str(torch.device("cuda", torch.cuda.current_device()))]
             if torch.cuda.is_available() else ["cpu"])
    return {
        "process_index": index,
        "process_count": count,
        "local_devices": local,
        "global_device_count": count,
    }
