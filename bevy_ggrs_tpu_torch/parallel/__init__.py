"""Speculative branch batching: candidate input futures as a leading
tensor axis (``parallel/speculate.py``). Device-mesh sharding is not
ported yet (ROADMAP.md, port queue item 8)."""

from bevy_ggrs_tpu_torch.parallel.speculate import (
    BranchSampler,
    SpecResult,
    SpeculativeExecutor,
    enumerate_branches,
    match_branch,
    merge_rings,
)
