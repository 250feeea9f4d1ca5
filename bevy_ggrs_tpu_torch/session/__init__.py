"""Session protocol layer: the SyncTest session and the request protocol
every session flavor speaks (counterpart of ``bevy_ggrs_tpu/session``)."""

from bevy_ggrs_tpu_torch.session.common import (
    EventKind,
    GGRSError,
    InvalidRequest,
    MismatchedChecksum,
    NetworkStats,
    NotSynchronized,
    PredictionThreshold,
    SessionEvent,
    SessionState,
    NULL_FRAME,
)
from bevy_ggrs_tpu_torch.session.requests import (
    AdvanceFrame,
    LoadGameState,
    RestoreGameState,
    SaveGameState,
)
from bevy_ggrs_tpu_torch.session.input_queue import InputQueue
from bevy_ggrs_tpu_torch.session.synctest import SyncTestSession
