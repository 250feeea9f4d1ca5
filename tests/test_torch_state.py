"""PyTorch port, state core: the checksum, the snapshot ring and the
host round trip, held bitwise against the JAX package on the CPU.

Random worlds cover bool/u8/i32/f32 components, a component of more than
64 words, absent components, dead slots, multi-leaf and zero-word
resources, and capacities that are not multiples of the Pallas kernel's
512-slot block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_ggrs_tpu import state as js
from bevy_ggrs_tpu.ops.checksum import checksum_pallas
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.ops import checksum as tck

CAPACITIES = [1, 37, 600]

COMPONENTS = {  # name -> (shape, numpy dtype, torch dtype)
    "flag": ((), np.bool_, torch.bool),
    "bytes": ((3,), np.uint8, torch.uint8),
    "hp": ((), np.int32, torch.int32),
    "pos": ((2,), np.float32, torch.float32),
    "grid": ((70,), np.float32, torch.float32),
}


def random_host(seed: int, cap: int) -> dict:
    """A world in the numpy layout of ``to_host``."""
    rng = np.random.RandomState(seed)
    alive = rng.rand(cap) < 0.7
    comps = {}
    for name, (shape, dt, _) in COMPONENTS.items():
        if dt == np.bool_:
            comps[name] = rng.rand(cap, *shape) < 0.5
        elif dt == np.float32:
            comps[name] = rng.randn(cap, *shape).astype(np.float32)
        else:
            info = np.iinfo(dt)
            comps[name] = rng.randint(info.min, info.max, size=(cap,) + shape,
                                      dtype=np.int64).astype(dt)
    present = {n: alive & (rng.rand(cap) < 0.8) for n in comps}
    present["hp"][:] = False  # a registered component no entity has
    return {
        "alive": alive,
        "rollback_id": np.where(alive, rng.randint(0, 1 << 20, cap), -1).astype(np.int32),
        "components": comps,
        "present": present,
        "resources": {
            "frame_count": np.array(rng.randint(0, 2**32, dtype=np.int64), np.uint32),
            "multi": {
                "a": rng.randn(3).astype(np.float32),
                "b": (np.array(rng.randint(-100, 100), np.int32),
                      rng.rand(2, 2) < 0.5),
            },
            "empty": np.zeros((0,), np.float32),
        },
    }


def torch_registry() -> ts.TypeRegistry:
    reg = ts.TypeRegistry()
    for name, (shape, _, tdt) in COMPONENTS.items():
        reg.register_component(name, shape, tdt)
    reg.register_resource("frame_count", np.uint32(0))
    reg.register_resource("multi", {"a": np.zeros(3, np.float32),
                                    "b": (np.int32(0), np.zeros((2, 2), bool))})
    reg.register_resource("empty", np.zeros((0,), np.float32))
    return reg


def jax_world(host: dict) -> js.WorldState:
    return js.WorldState(
        alive=jnp.asarray(host["alive"]),
        rollback_id=jnp.asarray(host["rollback_id"]),
        components={n: jnp.asarray(a) for n, a in host["components"].items()},
        present={n: jnp.asarray(a) for n, a in host["present"].items()},
        resources=jax.tree_util.tree_map(jnp.asarray, host["resources"]),
    )


def torch_world(host: dict) -> ts.WorldState:
    return ts.from_host(torch_registry(), host, device="cpu")


@pytest.mark.parametrize("cap", CAPACITIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_checksum_bitwise_equals_jax(seed, cap):
    host = random_host(seed, cap)
    jw, tw = jax_world(host), torch_world(host)
    want = js.combine64(js.checksum(jw))
    assert js.combine64(checksum_pallas(jw)) == want
    assert ts.combine64(ts.checksum(tw)) == want
    assert ts.combine64(tck.checksum(tw)) == want


@pytest.mark.parametrize("cap", CAPACITIES)
def test_checksum_breakdown_equals_jax(cap):
    host = random_host(3, cap)
    assert ts.checksum_breakdown(torch_world(host)) == js.checksum_breakdown(
        jax_world(host))


@pytest.mark.parametrize("dtype", [np.bool_, np.uint8, np.int8, np.int16,
                                   np.float16, np.int32, np.float32])
def test_u32_words_equal_jax(dtype):
    rng = np.random.RandomState(0)
    a = (rng.randn(5, 2, 3) * 50).astype(dtype)
    want = np.asarray(js._to_u32_words(jnp.asarray(a)))
    got = ts._to_u32_words(torch.from_numpy(a), 1).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_entity_hash_sum_over_ring_rows_equals_each_row():
    """The batch axis carries ring rows: one call over ``[depth]`` gives
    each row's own digest."""
    rows = [torch_world(random_host(s, 37)) for s in range(4)]
    stacked = ts.tree_map(lambda *xs: torch.stack(xs), *rows)
    batched = tck.checksum(stacked)
    assert batched.shape == (4, 2)
    for r, w in enumerate(rows):
        assert torch.equal(batched[r], ts.checksum(w))


def test_kernel_wrapper_uses_plain_version_on_cpu_and_checks_inputs():
    """Each mode of the kernel's wrapper takes its plain version for a CPU
    world, counts no launch, and refuses arguments its mode does not
    take."""
    w = torch_world(random_host(0, 37))
    ring = ts.ring_init(w, 3)
    before = tck.world_checksum.launches
    out = tck.world_checksum(w)
    assert out.dtype == torch.int64 and out.shape == (2,)
    assert torch.equal(out, ts.checksum(w))
    saved = tck.world_checksum(w, "save", ring=ring, frame=4)
    assert torch.equal(saved, out) and int(ring.frames[1]) == 4
    flag = tck.world_checksum(None, "guard", ring=ring, frame=4)
    assert flag.dtype == torch.int32 and flag.tolist() == [1]
    assert tck.world_checksum.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError):
        tck.world_checksum(w, "hash")
    with pytest.raises(ValueError):
        tck.world_checksum(w, "save")  # no ring
    with pytest.raises(ValueError):
        tck.world_checksum(w, "guard", ring=ring)  # a state it does not take


@pytest.mark.parametrize("cap", CAPACITIES)
def test_from_host_to_host_round_trip(cap):
    host = random_host(5, cap)
    back = ts.to_host(torch_world(host))
    flat_a, _ = jax.tree_util.tree_flatten(host)
    flat_b, _ = jax.tree_util.tree_flatten(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_box_game_world_round_trips_from_jax_to_host():
    from bevy_ggrs_tpu.models import box_game as jbox

    host = js.to_host(jbox.make_world(2).commit())
    tw = ts.from_host(tbox.make_registry(), host, device="cpu")
    assert ts.combine64(ts.checksum(tw)) == js.combine64(
        js.checksum(jbox.make_world(2).commit()))
    back = ts.to_host(tw)
    assert back["resources"]["frame_count"].dtype == np.uint32
    np.testing.assert_array_equal(back["components"]["translation"],
                                  host["components"]["translation"])


def test_ring_save_load_frame_at_equal_jax():
    hosts = [random_host(s, 37) for s in range(7)]
    jring = js.ring_init(jax_world(hosts[0]), 4)
    tring = ts.ring_init(torch_world(hosts[0]), 4)
    for frame, host in enumerate(hosts):
        jring, jcs = js.ring_save(jring, jax_world(host), frame)
        tring, tcs = ts.ring_save(tring, torch_world(host), frame)
        assert ts.combine64(tcs) == js.combine64(jcs)
    np.testing.assert_array_equal(tring.frames.numpy(), np.asarray(jring.frames))
    np.testing.assert_array_equal(tring.checksums.numpy(),
                                  np.asarray(jring.checksums).astype(np.int64))
    for frame in range(3, 7):
        assert ts.ring_frame_at(tring, frame) == frame
        loaded = ts.ring_load(tring, frame)
        assert ts.combine64(ts.checksum(loaded)) == js.combine64(
            js.checksum(js.ring_load(jring, frame)))
    assert ts.ring_frame_at(tring, 2) == 6  # frame 2's slot now holds 6


def test_ring_rows_are_not_aliased():
    tw = torch_world(random_host(0, 37))
    ring = ts.ring_init(tw, 3)
    other = torch_world(random_host(1, 37))
    ts.ring_save(ring, other, 0)
    row1 = ts.ring_load(ring, 1)
    assert ts.combine64(ts.checksum(row1)) == ts.combine64(ts.checksum(tw))
    assert ts.combine64(ts.checksum(ts.ring_load(ring, 0))) == ts.combine64(
        ts.checksum(other))


def test_ring_load_is_a_copy():
    tw = torch_world(random_host(0, 37))
    ring = ts.ring_init(tw, 2)
    ring, cs = ts.ring_save(ring, tw, 0)
    loaded = ts.ring_load(ring, 0)
    ts.ring_save(ring, torch_world(random_host(1, 37)), 2)  # same row
    assert ts.combine64(ts.checksum(loaded)) == ts.combine64(cs)


def test_commit_does_not_alias_the_staging_world():
    world = tbox.make_world(2, device="cpu")
    committed = world.commit()
    before = ts.combine64(ts.checksum(committed))
    world.despawn(0)
    world.spawn({"translation": [9.0, 9.0, 9.0], "velocity": [1.0, 1.0, 1.0],
                 "player_handle": 0}, rollback_id=7)
    world.set_resource("frame_count", 5)
    assert ts.combine64(ts.checksum(committed)) == before
    assert ts.combine64(ts.checksum(world.commit())) != before


def test_u32_resource_increment_wraps():
    x = torch.tensor(2**32 - 1, dtype=torch.uint32)
    assert int(tbox.increment_u32(x)) == 0
    assert int(tbox.increment_u32(torch.tensor(41, dtype=torch.uint32))) == 42
