"""Parallelism layer: speculative branch batching (``parallel/speculate.py``)
and device-mesh sharding over ``torch.distributed``
(``parallel/sharding.py``, ``parallel/multihost.py``)."""

from bevy_ggrs_tpu_torch.parallel.speculate import (
    BranchSampler,
    SpecResult,
    SpeculativeExecutor,
    enumerate_branches,
    match_branch,
    merge_rings,
)
from bevy_ggrs_tpu_torch.parallel.sharding import branch_mesh, shard_branch_axis
