"""Session protocol layer (counterpart of ``bevy_ggrs_tpu/session``): the
three session flavors and the request protocol they all speak.

- :class:`SyncTestSession`: every player local; forces a rollback every
  frame and compares checksums (the determinism harness).
- :class:`P2PSession`: peers over loopback or UDP, input prediction,
  rollback on misprediction, the desync-detection checksum exchange.
- :class:`SpectatorSession`: confirmed inputs from a host; never rolls
  back.

``advance_frame()`` returns an ordered list of Save/Load/Advance requests
that the runner executes. The wire protocol (``session/protocol.py``) is
byte for byte the JAX package's, so a session of either package plays
against a session of the other.
"""

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
from bevy_ggrs_tpu_torch.session.p2p import P2PSession
from bevy_ggrs_tpu_torch.session.spectator import SpectatorSession
from bevy_ggrs_tpu_torch.session.builder import PlayerType, SessionBuilder
