"""bevy_ggrs_tpu_torch: the rollback engine of ``bevy_ggrs_tpu`` in PyTorch,
with its TPU kernels rewritten by hand in CUDA for NVIDIA Hopper.

This package runs SyncTest, P2P (speculating too) and spectator sessions on
box_game and on boids flocks (dense, and the neighbour grid). Its wire protocol is byte for
byte the JAX package's, so a peer or spectator of either package plays in
one session with the other's. It imports ``torch`` and ``numpy`` only; its
entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from bevy_ggrs_tpu_torch.state import (
    DEVICE_ID_BASE,
    HostWorld,
    SnapshotRing,
    TypeRegistry,
    WorldState,
    checksum,
    checksum_breakdown,
    combine64,
    from_host,
    init_state,
    ring_frame_at,
    ring_init,
    ring_load,
    ring_save,
    to_host,
)
from bevy_ggrs_tpu_torch.schedule import InputSpec, PlayerInputs, Schedule
