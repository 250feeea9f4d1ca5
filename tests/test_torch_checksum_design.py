"""PyTorch port, the checksum kernel's design, held on the CPU.

The kernel (``csrc/checksum.cu``) reads the world's own tensors through a
layout built by ``ops/checksum.py``: parts in mixing order, each with its
words a slot, its word size, its bytes a world row and, for resource
leaves, the name seed and word positions. These tests hold that layout
against the word matrix of both packages, and a numpy emulation of the
kernel's walk (read from the layout and the tensors' raw bytes, u32
arithmetic, the cluster's blocks added in ascending rank) bitwise against
``state.checksum`` and JAX's ``checksum_pallas`` in interpret mode. They
also cover the cluster launch shape, and the plain versions of the save
and guard modes that a CPU world takes.
"""

import ctypes
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_ggrs_tpu import state as js
from bevy_ggrs_tpu.ops import checksum as jck
from bevy_ggrs_tpu_torch import integrity
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.ops import checksum as tck

ROOT = pathlib.Path(__file__).resolve().parent.parent

# Component kinds: (numpy dtype, torch dtype, shape).
KINDS = [
    (np.bool_, torch.bool, ()),
    (np.uint8, torch.uint8, (3,)),
    (np.int8, torch.int8, ()),
    (np.int16, torch.int16, (2,)),
    (np.float16, torch.float16, ()),
    (np.int32, torch.int32, ()),
    (np.float32, torch.float32, (70,)),
]
WIDE_KINDS = [  # 8-byte elements: the port only (JAX runs without x64)
    (np.int64, torch.int64, ()),
    (np.float64, torch.float64, (2,)),
]


def values(rng, dt, shape):
    if dt == np.bool_:
        return rng.rand(*shape) < 0.5
    if np.issubdtype(dt, np.floating):
        return (rng.randn(*shape) * 50).astype(dt)
    info = np.iinfo(dt)
    return rng.randint(info.min, info.max, size=shape, dtype=np.int64).astype(dt)


def random_schema(seed: int, wide: bool = False):
    """Component names (random, so their sorted order varies) with kinds,
    and a nested resource tree."""
    rng = np.random.RandomState(seed)
    kinds = KINDS + (WIDE_KINDS if wide else [])
    names = ["".join(rng.choice(list("abcdefgh"), 5)) + str(i) for i in range(len(kinds))]
    comps = {n: k for n, k in zip(names, kinds)}
    resources = {
        "frame_count": (np.uint32, ()),
        "tree": {"b": ((np.int16, (3,)), (np.bool_, (2, 2))),
                 "a": (np.float16, (5,)), "e": (np.float32, (0,))},
        "z": (np.uint8, ()),
    }
    if wide:
        resources["wide"] = (np.int64, (2,))
    return comps, resources


def is_spec(x):
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], tuple) \
        and not isinstance(x[0], tuple)


def resource_values(rng, spec, lead=()):
    if isinstance(spec, dict):
        return {k: resource_values(rng, v, lead) for k, v in spec.items()}
    if is_spec(spec):
        dt, shape = spec
        return np.asarray(values(rng, dt, lead + shape), dt)
    return tuple(resource_values(rng, v, lead) for v in spec)


def random_host(schema, seed: int, cap: int, lead=()) -> dict:
    comps, resources = schema
    rng = np.random.RandomState(1000 + seed)
    alive = rng.rand(*lead, cap) < 0.7
    return {
        "alive": alive,
        "rollback_id": np.where(alive, rng.randint(0, 1 << 20, lead + (cap,)), -1).astype(np.int32),
        "components": {n: values(rng, dt, lead + (cap,) + shape)
                       for n, (dt, _, shape) in comps.items()},
        "present": {n: alive & (rng.rand(*lead, cap) < 0.8) for n in comps},
        "resources": {n: resource_values(rng, spec, lead) for n, spec in resources.items()},
    }


def torch_world(schema, host: dict) -> ts.WorldState:
    comps, _ = schema
    return ts.WorldState(
        alive=torch.from_numpy(host["alive"].copy()),
        rollback_id=torch.from_numpy(host["rollback_id"].copy()),
        components={n: torch.from_numpy(np.ascontiguousarray(host["components"][n]))
                    for n in comps},
        present={n: torch.from_numpy(host["present"][n].copy()) for n in comps},
        resources=ts.tree_map(lambda a: torch.from_numpy(np.array(a)), host["resources"]),
    )


def jax_world(host: dict) -> js.WorldState:
    return js.WorldState(
        alive=jnp.asarray(host["alive"]),
        rollback_id=jnp.asarray(host["rollback_id"]),
        components={n: jnp.asarray(a) for n, a in host["components"].items()},
        present={n: jnp.asarray(a) for n, a in host["present"].items()},
        resources=jax.tree_util.tree_map(jnp.asarray, host["resources"]),
    )


# ---------------------------------------------------------------------------
# The numpy emulation of the kernel's walk
# ---------------------------------------------------------------------------

U32 = np.uint32


def rotl(x, r):
    return (x << U32(r)) | (x >> U32(32 - r))


def mix_one(h, w):
    k = rotl(w * U32(ts._C1), 15) * U32(ts._C2)
    return rotl(h ^ k, 13) * U32(5) + U32(0xE6546B64)


def fmix(h):
    h = h ^ (h >> U32(16))
    h = h * U32(0x85EBCA6B)
    h = h ^ (h >> U32(13))
    h = h * U32(0xC2B2AE35)
    return h ^ (h >> U32(16))


def raw_rows(t: torch.Tensor, B: int, row_bytes: int) -> np.ndarray:
    """``t``'s bytes as ``uint8[B, row_bytes]``."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().reshape(B, row_bytes)


def read_words(row: np.ndarray, spec) -> np.ndarray:
    """A world row's bytes as the kernel reads its words."""
    if spec.word_bytes == 4:
        return row.view("<u4").astype(U32)
    if spec.word_bytes == 2:
        return row.view("<u2").astype(U32)
    w = row.astype(U32)
    return (w != 0).astype(U32) if spec.is_bool else w


def entity_words(lay, rows, b):
    """The ``[cap]`` word columns in the order the kernel mixes them, each
    component's masked by its presence bit."""
    cap = lay.capacity
    present = np.ones(cap, bool)
    for spec, r in zip(lay.parts, rows):
        if spec.role in (tck.ALIVE, tck.RESOURCE):
            continue
        words = read_words(r[b], spec).reshape(cap, spec.words)
        for k in range(spec.words):
            w = words[:, k]
            if spec.role == tck.COMPONENT:
                w = np.where(present, w, U32(0))
            yield w
            if spec.role == tck.PRESENCE:
                present = w != 0


def resource_lanes(lay, rows, b) -> np.ndarray:
    """The resource words' hashes summed (both lanes), without the
    constant term."""
    total = np.zeros(2, U32)
    for spec, r in zip(lay.parts, rows):
        if spec.role != tck.RESOURCE:
            continue
        w = read_words(r[b], spec)
        pos = (np.arange(spec.base, spec.base + spec.words, dtype=np.uint64)
               * ts._HI_TWEAK % (1 << 32)).astype(U32)
        total = total + np.array([fmix(mix_one(U32(seed) ^ pos, w)).sum(dtype=U32)
                                  for seed in spec.seeds], U32)
    return total


def emulate(lay, tensors) -> np.ndarray:
    """The kernel's output for ``tensors`` (in part order): ``int64[*lead, 2]``."""
    B = int(np.prod(lay.lead, dtype=np.int64))
    cap = lay.capacity
    rows = [raw_rows(t, B, spec.row_bytes) for t, spec in zip(tensors, lay.parts)]
    alive_at = [p.role for p in lay.parts].index(tck.ALIVE)
    P, _ = tck.launch_shape(cap)
    out = np.zeros((B, 2), U32)
    for b in range(B):
        h = np.stack([np.full(cap, ts._SEED, U32), np.full(cap, ts._SEED ^ ts._HI_TWEAK, U32)])
        for w in entity_words(lay, rows, b):
            h = mix_one(h, w[None, :])
        lanes = np.where(rows[alive_at][b][None, :] != 0, fmix(h), U32(0))
        total = np.array(lay.const, U32)
        for rank in range(P):  # the cluster's blocks in ascending rank
            s = tck.block_slots(cap, P, rank)
            block = lanes[:, s.start:s.stop].sum(axis=1, dtype=U32)
            if rank == 0:
                block = block + resource_lanes(lay, rows, b)
            total = total + block
        out[b] = total
    return out.astype(np.int64).reshape(lay.lead + (2,))


def emulate_state(state):
    lay, tensors = tck._prepared(state)
    return lay, emulate(lay, tensors)


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------

SEEDS = [0, 1, 2]


@pytest.mark.parametrize("seed", SEEDS)
def test_layout_parts_follow_the_mixing_order(seed):
    schema = random_schema(seed)
    state = torch_world(schema, random_host(schema, seed, 5))
    lay = tck.layout(state)
    comps = sorted(schema[0])
    names = (["rollback_id"] + [f"{k}/{n}" for n in comps for k in ("present", "component")]
             + ["alive"])
    assert [p.name for p in lay.parts[:len(names)]] == names
    roles = ([tck.WORDS] + [tck.PRESENCE, tck.COMPONENT] * len(comps) + [tck.ALIVE])
    assert [p.role for p in lay.parts[:len(names)]] == roles
    for spec in lay.parts[1:len(names) - 1]:
        if spec.role == tck.PRESENCE:
            assert (spec.words, spec.word_bytes, spec.is_bool, spec.row_bytes) == (1, 1, True, 5)
            continue
        dt, _, shape = schema[0][spec.name.split("/")[1]]
        size = np.dtype(dt).itemsize
        n = int(np.prod(shape, dtype=np.int64))
        assert spec.words == n and spec.word_bytes == size
        assert spec.is_bool == (dt == np.bool_)
        assert spec.row_bytes == 5 * n * size
    assert lay.capacity == 5 and lay.lead == ()
    # The zero-word leaf ("tree/e") is no part; positions run on across a
    # resource's leaves and restart at the next resource.
    res = [p for p in lay.parts if p.role == tck.RESOURCE]
    assert [(p.name, p.words, p.base, p.first) for p in res] == [
        ("resource/frame_count/0", 1, 0, 0),
        ("resource/tree/0", 5, 0, 1),
        ("resource/tree/1", 3, 5, 6),
        ("resource/tree/2", 4, 8, 9),
        ("resource/z/0", 1, 0, 13),
    ]
    assert lay.resource_words == 14


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cap", [1, 37, 600])
def test_layout_words_equal_both_word_matrices(seed, cap):
    """The words the kernel reads from the raw bytes, masked in
    registers, are the rows of the port's and JAX's ``_word_matrix``."""
    schema = random_schema(seed)
    host = random_host(schema, seed, cap)
    state = torch_world(schema, host)
    lay, tensors = tck._prepared(state)
    rows = [raw_rows(t, 1, spec.row_bytes) for t, spec in zip(tensors, lay.parts)]
    got = np.stack(list(entity_words(lay, rows, 0)))
    np.testing.assert_array_equal(got, tck._word_matrix(state)[0].numpy().view(U32))
    np.testing.assert_array_equal(got, np.asarray(jck._word_matrix(jax_world(host))))


@pytest.mark.parametrize("seed", SEEDS)
def test_layout_resource_seeds_positions_and_constants(seed):
    schema = random_schema(seed)
    host = random_host(schema, seed, 4)
    state = torch_world(schema, host)
    lay, tensors = tck._prepared(state)
    want_const = []
    for name in sorted(schema[1]):
        ns = ts._name_seed(name)
        seeds = np.array([js._SEED ^ ns, js._SEED ^ js._HI_TWEAK ^ ns], np.uint32)
        want_const.append((name, *(int(x) for x in js._fmix(seeds))))
    assert list(lay.constants) == want_const
    assert lay.const == (sum(c[1] for c in want_const) & 0xFFFFFFFF,
                         sum(c[2] for c in want_const) & 0xFFFFFFFF)
    for spec in lay.parts:
        if spec.role == tck.RESOURCE:
            ns = ts._name_seed(spec.name.split("/")[1])
            assert spec.seeds == (js._SEED ^ ns, js._SEED ^ js._HI_TWEAK ^ ns)
    rows = [raw_rows(t, 1, spec.row_bytes) for t, spec in zip(tensors, lay.parts)]
    lanes = (resource_lanes(lay, rows, 0) + np.array(lay.const, U32)).astype(np.int64)
    np.testing.assert_array_equal(lanes, ts._resources_checksum(state.resources, "cpu").numpy())
    np.testing.assert_array_equal(
        lanes, np.asarray(js._resources_checksum(jax_world(host).resources)).astype(np.int64))


def test_layout_is_cached_per_structure():
    schema = random_schema(0)
    a = torch_world(schema, random_host(schema, 0, 9))
    b = torch_world(schema, random_host(schema, 1, 9))
    assert tck.layout(a) is tck.layout(b)
    assert tck.layout(torch_world(schema, random_host(schema, 0, 10))) is not tck.layout(a)


def test_world_over_the_part_limit_raises_naming_it():
    def world(n_comps, resources):
        reg = ts.TypeRegistry()
        for i in range(n_comps):
            reg.register_component(f"c{i:03d}", (), torch.int32)
        for i in range(resources):
            reg.register_resource(f"r{i}", np.int32(0))
        return ts.init_state(reg, 2, device="cpu")

    # rollback id + 2 per component + alive: 127 components are 256 parts.
    assert len(tck.layout(world(127, 0)).parts) == tck.MAX_PARTS == 256
    with pytest.raises(ValueError, match="limit of 256"):
        tck.layout(world(127, 1))
    with pytest.raises(ValueError, match="limit of 256"):
        tck.layout(world(300, 0))


def test_c_source_agrees_with_the_wrapper():
    """The kernel's largest block, unroll and part limit are the wrapper's."""
    src = (ROOT / "bevy_ggrs_tpu_torch" / "csrc" / "checksum.cu").read_text()
    assert re.search(r"constexpr int kMaxThreads = (\d+);", src).group(1) == str(tck.MAX_THREADS)
    assert re.search(r"constexpr int kUnroll = (\d+);", src).group(1) == str(tck.UNROLL)
    assert f"h->n_parts <= {tck.MAX_PARTS}" in src
    # Field counts of the structs the C entry reads; the header ends in the
    # save's four batch steps (8-byte aligned after the two u32 constants),
    # then the slot save's per-slot frames, keep-mask and ring depth.
    assert len(tck._Part._fields_) == 11 and len(tck._Header._fields_) == 23
    assert [f for f, _ in tck._Header._fields_[-7:-3]] == [
        "dst_rows", "lanes_ring_stride", "frame_stride", "lanes_out_stride"]
    assert all(f"long long {f};" in src for f, _ in tck._Header._fields_[-7:-3])
    assert [f for f, _ in tck._Header._fields_[-3:]] == ["world_frames", "keep", "depth"]
    assert all(decl in src for decl in ("const int* world_frames;",
                                        "const unsigned char* keep;", "int depth;"))
    # ... and after them the two slot pointers, the depth and its padding.
    assert ctypes.sizeof(tck._Header) == 7 * 8 + 9 * 4 + 4 + 4 * 8 + 2 * 8 + 4 + 4


# ---------------------------------------------------------------------------
# The walk, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cap", [1, 37, 600])
def test_emulated_walk_equals_checksum_and_jax_pallas(seed, cap):
    schema = random_schema(seed)
    host = random_host(schema, seed, cap)
    state = torch_world(schema, host)
    _, got = emulate_state(state)
    assert torch.equal(torch.from_numpy(got), ts.checksum(state))
    assert torch.equal(tck.checksum(state), ts.checksum(state))
    want = np.asarray(jck.checksum_pallas(jax_world(host))).astype(np.int64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_emulated_walk_with_8_byte_parts_equals_plain_checksum(seed):
    schema = random_schema(seed, wide=True)
    state = torch_world(schema, random_host(schema, seed, 37))
    lay, got = emulate_state(state)
    wide = [p for p in lay.parts if p.name.startswith("component/")
            and state.components[p.name.split("/")[1]].element_size() == 8]
    assert len(wide) == 2 and all(p.word_bytes == 4 for p in wide)
    assert {p.words for p in wide} == {2, 4}  # int64 (), float64 (2,): low word first
    assert torch.equal(torch.from_numpy(got), ts.checksum(state))


@pytest.mark.parametrize("lead", [(4,), (2, 3)], ids=["ring", "stack"])
@pytest.mark.parametrize("wide", [False, True])
def test_emulated_walk_over_stacked_rows_equals_each_rows_checksum(lead, wide):
    schema = random_schema(5, wide=wide)
    host = random_host(schema, 5, 37, lead=lead)
    stacked = torch_world(schema, host)
    lay, got = emulate_state(stacked)
    assert lay.lead == lead and got.shape == lead + (2,)
    plain = tck.checksum(stacked)
    for idx in np.ndindex(*lead):
        row = ts.tree_map(lambda x: x[idx], stacked)
        assert torch.equal(torch.from_numpy(got[idx]), ts.checksum(row)), idx
        assert torch.equal(plain[idx], ts.checksum(row)), idx


# ---------------------------------------------------------------------------
# The launch shape
# ---------------------------------------------------------------------------


def test_launch_shape_partitions_every_row_from_1_to_70000():
    for cap in range(1, 70001):
        P, threads = tck.launch_shape(cap)
        assert P in (1, 2, 4, 8) and threads % 32 == 0 and 32 <= threads <= tck.MAX_THREADS
        assert P == 1 or (P // 2) * 128 < cap  # spread only as far as needed
        blocks = [tck.block_slots(cap, P, r) for r in range(P)]
        assert blocks[0].start == 0 and blocks[-1].stop == cap
        assert all(a.stop == b.start for a, b in zip(blocks, blocks[1:]))
        widest = max(len(b) for b in blocks)
        assert threads >= min(widest, tck.MAX_THREADS)  # a thread a slot while it can
        assert threads - 32 < widest  # no warp without a slot
        assert widest <= threads * tck.UNROLL or P == tck.MAX_CLUSTER


@pytest.mark.parametrize("cap", [1, 2, 16, 37, 600, 1000, 1023, 1024, 1025, 4096, 4097,
                                 8193, 32767, 32768, 32769, 40000, 70000])
def test_every_slot_is_walked_by_exactly_one_thread(cap):
    P, threads = tck.launch_shape(cap)
    walked = np.concatenate([np.fromiter(tck.thread_slots(cap, P, threads, r, t), np.int64)
                             for r in range(P) for t in range(threads)])
    np.testing.assert_array_equal(np.sort(walked), np.arange(cap))
    if cap <= P * threads * tck.UNROLL:  # one chunk: at most UNROLL slots a thread
        assert max(len(list(tck.thread_slots(cap, P, threads, r, 0)))
                   for r in range(P)) <= tck.UNROLL


def test_launch_shapes_at_the_main_path_capacities():
    """The shapes a sweep on the card found fastest (8 x 128 at 1,024, 8 x
    512 at 4,096, 8 x 1,024 at 32,768)."""
    assert tck.launch_shape(16) == (1, 32)  # box_game
    assert tck.launch_shape(1024) == (8, 128)  # boids-1,024
    assert tck.launch_shape(4096) == (8, 512)  # boids-4,096
    assert tck.launch_shape(32768) == (8, 1024)  # boids-32,768 grid
    assert tck.launch_shape(40000) == (8, 1024)


# ---------------------------------------------------------------------------
# The save and guard modes on the CPU
# ---------------------------------------------------------------------------


def former_save(ring, state, frame):
    """The save as the port ran it before the kernel took it over."""
    slot = frame % ring.depth
    cs = ts.checksum(state)
    ts.tree_map(lambda r, s: r[slot].copy_(s), ring.states, state)
    ring.frames[slot] = frame
    ring.checksums[slot] = cs
    return cs


def clone_ring(ring):
    return ts.SnapshotRing(states=ts.tree_map(torch.clone, ring.states),
                           frames=ring.frames.clone(), checksums=ring.checksums.clone())


@pytest.mark.parametrize("wide", [False, True])
def test_save_mode_on_cpu_equals_the_tree_map_path(wide):
    schema = random_schema(7, wide=wide)
    worlds = [torch_world(schema, random_host(schema, s, 37)) for s in range(6)]
    ring = ts.ring_init(worlds[0], 4)
    twin = clone_ring(ring)
    out = torch.zeros((6, 2), dtype=torch.int64)
    for frame, w in enumerate(worlds):
        _, cs = ts.ring_save(ring, w, frame, out=out[frame])
        want = former_save(twin, w, frame)
        assert torch.equal(cs, want) and torch.equal(out[frame], want)
        assert cs.data_ptr() != ring.checksums[frame % 4].data_ptr()
    for a, b in zip(ts.tree_leaves(ts.to_host(ring.states)), ts.tree_leaves(ts.to_host(twin.states))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert torch.equal(ring.frames, twin.frames) and ring.frames.tolist() == [4, 5, 2, 3]
    assert torch.equal(ring.checksums, twin.checksums)
    # The returned lanes are their own: a later save into the row keeps them.
    kept = cs.clone()
    ts.ring_save(ring, worlds[0], 9)  # row 1 again
    assert torch.equal(cs, kept)


def test_guard_mode_on_cpu():
    schema = random_schema(8)
    worlds = [torch_world(schema, random_host(schema, s, 37)) for s in range(5)]
    ring = ts.ring_init(worlds[0], 3)
    for frame, w in enumerate(worlds):
        ts.ring_save(ring, w, frame)
    assert integrity.verify_row(ring, 4)  # clean
    assert integrity.verify_row(ring, 1)  # its row now holds frame 4: not resident
    flipped, info = integrity.flip_ring_bit(ring, 4 % 3, np.random.RandomState(0))
    assert not integrity.verify_row(flipped, 4), info
    assert integrity.verify_row(flipped, 1)  # still not resident
    assert integrity.verify_row(flipped, 3)  # another row, untouched
    assert tck.world_checksum(None, "guard", ring=flipped, frame=4).tolist() == [0]


def test_no_launch_is_counted_on_the_cpu():
    schema = random_schema(9)
    w = torch_world(schema, random_host(schema, 0, 16))
    ring = ts.ring_init(w, 2)
    before = (tck.world_checksum.launches, tck.world_checksum.copies)
    tck.checksum(w)
    ts.ring_save(ring, w, 0)
    integrity.verify_row(ring, 0)
    integrity.ring_digests(ring)
    assert (tck.world_checksum.launches, tck.world_checksum.copies) == before


@pytest.mark.parametrize("mode", ["checksum", "save", "guard"])
def test_meta_tensors_raise_no_kernel(mode):
    schema = random_schema(9)
    w = ts.tree_map(lambda t: t.to("meta"), torch_world(schema, random_host(schema, 0, 16)))
    ring = ts.SnapshotRing(states=ts.tree_map(lambda x: x[None].expand((2,) + x.shape), w),
                           frames=torch.zeros((2,), dtype=torch.int32, device="meta"),
                           checksums=torch.zeros((2, 2), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        tck.world_checksum(None if mode == "guard" else w, mode,
                           ring=None if mode == "checksum" else ring)
