"""The relay tier's state codec, as far as the serving tier needs it.

Counterpart of ``bevy_ggrs_tpu/relay``. ``relay/delta.py``'s
``StateCodec`` (a world as deterministic flat bytes, byte-identical to the
JAX package's) and ``payload_digest`` carry the match checkpoints and
migration records of ``serve/``; the relay's client, server, streams and
fan-out tree come with the fleet tier.
"""

from bevy_ggrs_tpu_torch.relay.delta import StateCodec, payload_digest

__all__ = ["StateCodec", "payload_digest"]
