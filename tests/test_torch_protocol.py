"""PyTorch port, wire protocol: byte for byte the JAX package's.

Every message class, with the same fields, encodes to the same bytes in
both packages, and each package decodes the other's bytes to the same
fields; input spans pack identically; a bit flip anywhere in an
``InputMsg`` decodes to ``None`` or to a message outside the data plane in
both packages, never to an input.
"""

import dataclasses
import typing

import numpy as np
import pytest

from bevy_ggrs_tpu.session import protocol as jproto
from bevy_ggrs_tpu_torch.session import protocol as tproto


def message_fields():
    """One instance's fields for every message class, by class name; the
    values fill each struct field's range (negative frames, 64-bit
    checksums, payloads)."""
    return {
        "SyncRequest": dict(nonce=0xDEADBEEF, config_digest=0x0123456789ABCDEF),
        "SyncReply": dict(nonce=1, config_digest=0),
        "InputMsg": dict(handle=2, start_frame=100, payload=b"\x01\x02\x03", num=3,
                         ack_frame=-1, sender_frame=103, advantage=-2),
        "InputAck": dict(handle=0, ack_frame=-1),
        "QualityReport": dict(send_time_ms=123456, frame_advantage=-7),
        "QualityReply": dict(pong_time_ms=0xFFFFFFFF),
        "KeepAlive": dict(),
        "ChecksumReport": dict(frame=64, checksum=0xFEDCBA9876543210),
        "StateRequest": dict(nonce=77, kind=jproto.STATE_KIND_FULL, resend_from=3),
        "StateChunk": dict(nonce=5, kind=0, frame=-1, checksum=2**63 + 5, seq=2, total=9,
                           crc=0xABCDEF01, payload=bytes(range(40))),
        "RelayHello": dict(session_id=0xCAFEBABE, peer_id=65535),
        "RelayWelcome": dict(session_id=1, peer_id=2, epoch=0xFFFFFFFF),
        "RelayForward": dict(src=3, dst=4, payload=b"inner datagram"),
        "Subscribe": dict(session_id=9, cursor=-1, window=600),
        "StreamDelta": dict(frame=120, base_frame=119, crc=17, payload=b"\x00\xff" * 9),
        "StreamKeyframe": dict(frame=128, seq=0, total=1, crc=18, digest=2**64 - 1,
                               payload=b"kf"),
        "StreamAck": dict(frame=-5),
        "MigrateOffer": dict(nonce=1, match_id=2, frame=3, total=4, digest=5, epoch=6),
        "MigrateAccept": dict(nonce=7, accept=1, epoch=8, reason=jproto.MIG_REFUSE_DUP),
        "MigrateChunk": dict(nonce=9, frame=10, seq=11, total=12, crc=13, payload=b"mc",
                             epoch=14),
        "MigrateDone": dict(nonce=15, frame=-16, ok=0, epoch=17),
        "FleetHeartbeat": dict(server_id=18, frames_served=19, slots_active=20,
                               slots_free=21, quarantined=22, pages=23,
                               spec_hit_permille=999, spec_waste_permille=1,
                               beat_seq=0xFFFFFFFE),
        "CtrlFrame": dict(seq=24, crc=25, payload=b"\x47\x05\x13ctrl"),
        "CtrlAck": dict(seq=26),
    }


MESSAGE_NAMES = sorted(message_fields())


def test_every_message_class_is_covered():
    classes = {c.__name__ for c in typing.get_args(jproto.Message)}
    assert classes == set(MESSAGE_NAMES)
    assert {c.__name__ for c in typing.get_args(tproto.Message)} == classes


def test_constants_match():
    for name in dir(jproto):
        value = getattr(jproto, name)
        if name.isupper() and isinstance(value, (int, frozenset)):
            assert getattr(tproto, name) == value, name
    assert tproto.VERSION == 5


@pytest.mark.parametrize("name", MESSAGE_NAMES)
def test_encode_identical_and_decode_across(name):
    fields = message_fields()[name]
    jmsg = getattr(jproto, name)(**fields)
    tmsg = getattr(tproto, name)(**fields)
    wire = jproto.encode(jmsg)
    assert tproto.encode(tmsg) == wire
    got_t = tproto.decode(wire)  # the port decodes JAX's bytes
    got_j = jproto.decode(tproto.encode(tmsg))  # JAX decodes the port's
    assert type(got_t).__name__ == name and type(got_j).__name__ == name
    assert dataclasses.astuple(got_t) == dataclasses.astuple(jmsg)
    assert dataclasses.astuple(got_j) == dataclasses.astuple(tmsg)
    assert got_t == tmsg and got_j == jmsg


@pytest.mark.parametrize("dtype,shape", [(np.uint8, ()), (np.uint16, (3,)),
                                         (np.int32, (2, 2)), (np.float32, (4,))])
def test_input_spans_pack_identically(dtype, shape):
    rng = np.random.RandomState(3)
    for n in (0, 1, 7, 120):
        span = [(50 + i, np.asarray(rng.rand(*shape) * 200).astype(dtype)) for i in range(n)]
        packed = jproto.pack_input_span(span)
        assert tproto.pack_input_span(span) == packed
        start, num, payload = packed
        msg = tproto.InputMsg(handle=1, start_frame=start, payload=payload, num=num,
                              ack_frame=0, sender_frame=0, advantage=0)
        got_t = tproto.unpack_input_span(msg, np.dtype(dtype), shape)
        got_j = jproto.unpack_input_span(jproto.decode(tproto.encode(msg)),
                                         np.dtype(dtype), shape)
        assert [f for f, _ in got_t] == [f for f, _ in got_j] == [f for f, _ in span]
        for (_, a), (_, b), (_, c) in zip(got_t, got_j, span):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)
            assert a.dtype == b.dtype == np.dtype(dtype)


def input_wire():
    bits = np.arange(8, dtype=np.uint8)
    start, num, payload = tproto.pack_input_span([(200 + i, bits[i]) for i in range(8)])
    return tproto.encode(tproto.InputMsg(handle=1, start_frame=start, payload=payload,
                                         num=num, ack_frame=199, sender_frame=208,
                                         advantage=1))


@pytest.mark.parametrize("byte", range(len(input_wire())))
def test_any_bit_flip_of_an_input_is_dropped_in_both(byte):
    wire = input_wire()
    for bit in range(8):
        flipped = bytearray(wire)
        flipped[byte] ^= 1 << bit
        flipped = bytes(flipped)
        got_t, got_j = tproto.decode(flipped), jproto.decode(flipped)
        assert not isinstance(got_t, tproto.InputMsg)
        assert not isinstance(got_j, jproto.InputMsg)
        assert type(got_t).__name__ == type(got_j).__name__
        if got_t is not None:  # a type-byte flip into another family
            assert dataclasses.astuple(got_t) == dataclasses.astuple(got_j)
            assert type(got_t).__name__ not in ("SyncRequest", "SyncReply", "InputAck",
                                                "QualityReport", "QualityReply",
                                                "KeepAlive", "ChecksumReport")
        assert tproto.crc_mismatch(flipped) == jproto.crc_mismatch(flipped)
        assert tproto.version_mismatch(flipped) == jproto.version_mismatch(flipped)


def test_random_and_truncated_bytes_decode_alike():
    rng = np.random.RandomState(0)
    wires = [rng.bytes(int(rng.randint(0, 48))) for _ in range(1500)]
    for name in MESSAGE_NAMES:
        wire = tproto.encode(getattr(tproto, name)(**message_fields()[name]))
        wires += [wire[:cut] for cut in range(len(wire))]
    for data in wires:
        got_t, got_j = tproto.decode(data), jproto.decode(data)
        assert type(got_t).__name__ == type(got_j).__name__
        if got_t is not None:
            assert dataclasses.astuple(got_t) == dataclasses.astuple(got_j)


def test_version_skew_is_reported_alike():
    wire = bytearray(tproto.encode(tproto.KeepAlive()))
    wire[1] = 4
    assert tproto.decode(bytes(wire)) is None
    assert tproto.version_mismatch(bytes(wire)) == jproto.version_mismatch(bytes(wire)) == 4
