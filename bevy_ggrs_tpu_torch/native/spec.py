"""ctypes bindings for the native speculative branch-tree builder and matcher.

Counterpart of ``bevy_ggrs_tpu/native/spec.py``. The per-tick speculation
host path (candidate ranking, periodic extrapolation, branch-tensor
assembly, dedup signature, corrected-history branch match) lives in
``session_core.cpp`` next to the input queues it reads.
:func:`make_spec_builder` returns a :class:`NativeSpecBuilder` when the C++
core loads and the input dtype is supported, else ``None`` and the runner
keeps the Python path. Both paths are bitwise identical
(``tests/test_torch_native_spec.py``); ``GGRS_NO_NATIVE=1`` or
``BEVY_GGRS_TPU_NATIVE=0`` select the Python path.

Dtype contract: integer inputs of 1/2/4/8 bytes, except ``uint64``: the
native core normalizes elements to sign-extended int64, which is injective
for every other integer dtype but not for the uint64 value range (Python
compares those as positive big-ints).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from bevy_ggrs_tpu_torch.native import core as _core
from bevy_ggrs_tpu_torch.native.core import _i32p, _u8p


def _supported_dtype(dtype: np.dtype) -> bool:
    return (
        dtype.kind in ("i", "u")
        and dtype.itemsize in (1, 2, 4, 8)
        and not (dtype.kind == "u" and dtype.itemsize == 8)
    )


def _raw(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


class NativeSpecBuilder:
    """One-call-per-tick branch-tree builder over the native input-log
    mirror (kept in sync by :class:`MirroredLog`) and, when the session's
    queue set is native, the in-process confirmed frontier."""

    def __init__(
        self, zero: np.ndarray, num_players: int, num_branches: int,
        spec_frames: int, branch_values,
    ):
        zero = np.asarray(zero)  # zeros_np(P): [P, *shape]
        self._dtype = zero.dtype
        self._shape = zero.shape[1:]
        self._P = int(num_players)
        self._K = int(np.prod(self._shape, dtype=np.int64)) if self._shape else 1
        self._B = int(num_branches)
        self._F = int(spec_frames)
        self._elem = self._dtype.itemsize
        self._row_bytes = self._K * self._elem
        self._frame_bytes = self._P * self._row_bytes
        # The same dtype round trip the Python builder applies to
        # _branch_values, then the int64 normalization the core compares in.
        universe = np.asarray(list(branch_values), dtype=self._dtype)
        universe = np.ascontiguousarray(universe.reshape(-1).astype(np.int64))
        self._ptr = _core._lib.ggrs_sb_new(
            self._P, self._K, self._elem, int(self._dtype.kind == "i"),
            self._B, self._F,
            universe.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            int(universe.size), _u8p(_raw(zero)),
        )

    # Input-log mirror ---------------------------------------------------

    def log_set(self, frame: int, bits) -> None:
        arr = np.asarray(bits, dtype=self._dtype).reshape((self._P,) + self._shape)
        _core._lib.ggrs_sb_log_set(self._ptr, int(frame), _u8p(_raw(arr)))

    def log_del(self, frame: int) -> None:
        _core._lib.ggrs_sb_log_del(self._ptr, int(frame))

    def log_clear(self) -> None:
        _core._lib.ggrs_sb_log_clear(self._ptr)

    # Predictor seeding --------------------------------------------------

    def seed(self, anchor: int, pred_seed) -> None:
        """Install a predictor seed for ``anchor``
        (:class:`~bevy_ggrs_tpu_torch.predict.model.PredictorSeed`:
        ``traj[F, P]``, ``cand[P, 1, R]``, ``valid[P, 1, R]`` and
        ``content_hash``): the next build whose anchor matches uses the
        predictor trajectory as its effective base and the predictor
        ranking as its candidate rows, and folds the seed bytes into the
        dedup signature (mirroring the Python sig-tuple append)."""
        traj = _raw(np.asarray(pred_seed.traj, dtype=self._dtype))
        cand = np.asarray(pred_seed.cand, dtype=self._dtype)
        n_rank = int(cand.shape[-1])
        valid = np.ascontiguousarray(
            np.asarray(pred_seed.valid, dtype=bool)
        ).reshape(-1).view(np.uint8)
        _core._lib.ggrs_sb_seed(
            self._ptr, int(anchor), int(pred_seed.content_hash),
            _u8p(traj), _u8p(_raw(cand)), _u8p(valid), n_rank,
        )

    def clear_seed(self) -> None:
        _core._lib.ggrs_sb_clear_seed(self._ptr)

    # Build / match ------------------------------------------------------

    def qset_ptr(self, session) -> Optional[int]:
        """The session's native queue-set handle when its layout matches
        this builder (same dtype/payload/player count) — the build then
        reads the confirmed frontier in-process and the known-inputs query
        disappears from the tick entirely. Gated on the session exposing
        ``confirmed_span`` (only sessions that DO — p2p delegates it
        straight to these queues — let the Python path see the frontier;
        reading the queues of a session that doesn't would pin inputs the
        Python build leaves free)."""
        if getattr(session, "confirmed_span", None) is None:
            return None
        qs = getattr(session, "_qset", None)
        if (
            isinstance(qs, _core.NativeQueueSet)
            and qs._dtype == self._dtype
            and qs._nbytes == self._row_bytes
            and qs._num_players == self._P
        ):
            return qs._ptr
        return None

    def build(
        self, anchor: int, qs_ptr: Optional[int], known, mask,
        allow_skip: bool, prev_sig,
    ) -> Tuple[Optional[np.ndarray], int]:
        """``(branch_bits, sig)`` — ``branch_bits`` is ``None`` when
        ``allow_skip`` held and the dedup signature matched ``prev_sig``
        (the Python dedup-skip, decided natively). A fresh output buffer is
        allocated per call: a still-referenced previous ``SpecResult``
        keeps its tensor."""
        out = np.empty(
            self._B * self._F * self._frame_bytes, dtype=np.uint8
        )
        sig = ctypes.c_uint64()
        if qs_ptr is not None:
            known_p, mask_p = None, None
        else:
            known_p = _u8p(_raw(np.asarray(known, dtype=self._dtype)))
            mask_p = _u8p(_raw(np.asarray(mask, dtype=bool).view(np.uint8)))
        rc = _core._lib.ggrs_sb_build(
            self._ptr, qs_ptr, int(anchor), known_p, mask_p,
            int(bool(allow_skip)),
            int(prev_sig) if isinstance(prev_sig, int) else 0,
            _u8p(out), ctypes.byref(sig),
        )
        if rc == 1:
            return None, int(sig.value)
        if rc != 0:
            raise RuntimeError(f"ggrs_sb_build failed: rc={rc}")
        bits = out.view(self._dtype).reshape(
            (self._B, self._F, self._P) + self._shape
        )
        return bits, int(sig.value)

    def match(
        self, branch_bits: np.ndarray, start: int, load_frame: int,
        steps: np.ndarray, cap: int,
    ) -> Optional[Tuple[int, int]]:
        """Corrected-history branch match; ``None`` when the as-used log
        has a gap in ``[start, load_frame)`` (= the Python no-match)."""
        bb = np.asarray(branch_bits, dtype=self._dtype)
        st = np.asarray(steps, dtype=self._dtype)
        branch = ctypes.c_int32()
        depth = ctypes.c_int32()
        rc = _core._lib.ggrs_sb_match(
            self._ptr, _u8p(_raw(bb)), int(start), int(load_frame),
            _u8p(_raw(st)), int(st.shape[0]), int(cap),
            ctypes.byref(branch), ctypes.byref(depth),
        )
        if rc != 0:
            return None
        return int(branch.value), int(depth.value)

    def __del__(self):
        try:
            if self._ptr:
                _core._lib.ggrs_sb_free(self._ptr)
                self._ptr = None
        except Exception:
            pass


class MirroredLog(dict):
    """The runner's as-used input log, mirrored into the native builder.

    A real ``dict`` subclass: every reader (``get``/``max``/``sorted``/
    iteration — both the base :class:`RollbackRunner` and the speculative
    fallbacks touch ``_input_log`` directly) sees normal dict behavior,
    while the mutation primitives forward to the native mirror so the C++
    builder ranks candidates and fingerprints history from identical state.
    """

    def __init__(self, native: NativeSpecBuilder):
        super().__init__()
        self._native = native

    def __setitem__(self, frame, bits):
        super().__setitem__(frame, bits)
        self._native.log_set(frame, bits)

    def __delitem__(self, frame):
        super().__delitem__(frame)
        self._native.log_del(frame)

    def clear(self):
        super().clear()
        self._native.log_clear()

    def pop(self, frame, *default):
        if frame in self:
            val = self[frame]
            del self[frame]
            return val
        if default:
            return default[0]
        raise KeyError(frame)

    def popitem(self):
        frame = next(reversed(self))
        return frame, self.pop(frame)

    def setdefault(self, frame, default=None):
        if frame not in self:
            self[frame] = default
        return self[frame]

    def update(self, *args, **kwargs):
        for k, v in dict(*args, **kwargs).items():
            self[k] = v


def make_spec_builder(
    input_spec, num_players: int, num_branches: int, spec_frames: int,
    branch_values,
) -> Optional[NativeSpecBuilder]:
    """NativeSpecBuilder when the C++ core loads and the input dtype is in
    the native contract, else None (pure-Python path)."""
    if not _core.available():
        return None
    zero = np.asarray(input_spec.zeros_np(int(num_players)))
    if not _supported_dtype(zero.dtype):
        return None
    return NativeSpecBuilder(
        zero, num_players, num_branches, spec_frames, branch_values
    )


class NativeBatchPlane:
    """One-call-per-dispatch SoA staging for the batched serving core.

    Persistent ``[S, …]`` host buffers reused across dispatches, with
    per-slot builder handles installed on admit and dropped on retire.
    :meth:`stage` covers the pre-commit per-slot host loop (as-used log
    appends, in-flight tree matches, predictor window gather);
    :meth:`build` covers the post-commit loop (predictor seeding +
    branch-tree builds + no-op-lane tree re-use) and writes straight
    into the dispatch's ``[S, B, F]`` argument buffer. The C side
    loops over the same per-slot primitives the per-slot bindings call,
    so the batched path is bitwise identical by construction
    (``tests/test_torch_native_spec.py`` holds it against the JAX
    package's plane).
    """

    def __init__(
        self, zero: np.ndarray, num_players: int, num_slots: int,
        num_branches: int, spec_frames: int, max_frames: int,
        predictor=None,
    ):
        zero = np.asarray(zero)  # zeros_np(P): [P, *shape]
        self._dtype = zero.dtype
        self._shape = zero.shape[1:]
        P = self._P = int(num_players)
        S = self._S = int(num_slots)
        self._B = int(num_branches)
        F = self._F = int(spec_frames)
        MF = self._MF = int(max_frames)
        self._builders = (ctypes.c_void_p * S)()
        self._res_ptrs = (ctypes.c_void_p * S)()
        self._res_refs: list = [None] * S
        self._qs_ptrs = (ctypes.c_void_p * S)()
        # stage 1: log appends + in-flight tree matches
        self.log_mask = np.zeros(S, np.uint8)
        self.starts = np.zeros(S, np.int32)
        self.n_steps = np.zeros(S, np.int32)
        self.steps = np.zeros((S, MF, P) + self._shape, self._dtype)
        self.status = np.zeros((S, MF, P), np.int32)  # host-side only
        self.match_mask = np.zeros(S, np.uint8)
        self.res_anchors = np.zeros(S, np.int32)
        self.load_frames = np.zeros(S, np.int32)
        self.out_branch = np.full(S, -1, np.int32)
        self.out_depth = np.zeros(S, np.int32)
        # stage 2: tree builds / re-use copies
        self.build_mask = np.zeros(S, np.uint8)
        self.copy_mask = np.zeros(S, np.uint8)
        self.anchors = np.zeros(S, np.int32)
        self.known = np.zeros((S, F, P) + self._shape, self._dtype)
        self.kmask = np.zeros((S, F, P), np.uint8)
        self.out_sigs = np.zeros(S, np.uint64)
        # predictor window gather + seed render (scalar-payload contract:
        # the plane is only installed when K == 1, see make_batch_plane)
        self._predictor = predictor
        if predictor is not None:
            self._universe = np.ascontiguousarray(
                np.asarray(predictor.universe, dtype=np.int64)
            )
            V = self._V = int(self._universe.size)
            W = self._W = int(predictor.weights.window)
            self._seed_hash = int(predictor.content_hash)
            self.win_mask = np.zeros(S, np.uint8)
            self.win_anchors = np.zeros(S, np.int32)
            self.wins = np.full((S, W, P), -1, np.int32)
            self.seed_mask = np.zeros(S, np.uint8)
            self.seed_traj = np.zeros((S, F, P), self._dtype)
            self.seed_cand = np.zeros((S, P, V), self._dtype)
            self._seed_valid = np.ones(P * V, np.uint8)

    # Slot lifecycle -----------------------------------------------------

    def set_builder(self, slot: int, builder: Optional[NativeSpecBuilder]):
        self._builders[slot] = builder._ptr if builder is not None else None

    def set_res(self, slot: int, arr: Optional[np.ndarray]):
        """Point the slot's in-flight tree at ``arr`` (a contiguous
        ``[B, F, P, *shape]`` row, kept referenced here for the call)."""
        self._res_refs[slot] = arr
        self._res_ptrs[slot] = arr.ctypes.data if arr is not None else None

    def set_qs(self, slot: int, qs_ptr: Optional[int]):
        self._qs_ptrs[slot] = qs_ptr

    def reset_masks(self) -> None:
        self.log_mask[:] = 0
        self.match_mask[:] = 0
        self.build_mask[:] = 0
        self.copy_mask[:] = 0
        if self._predictor is not None:
            self.win_mask[:] = 0
            self.seed_mask[:] = 0

    # Batched calls ------------------------------------------------------

    def stage(self, cap: int) -> None:
        pred = self._predictor is not None
        rc = _core._lib.ggrs_batch_stage(
            self._builders, self._S, self._MF,
            _u8p(self.log_mask), _i32p(self.starts), _i32p(self.n_steps),
            _u8p(self.steps), _u8p(self.match_mask),
            self._res_ptrs, _i32p(self.res_anchors),
            _i32p(self.load_frames), int(cap),
            _i32p(self.out_branch), _i32p(self.out_depth),
            _u8p(self.win_mask) if pred else None,
            _i32p(self.win_anchors) if pred else None,
            self._universe.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)
            ) if pred else None,
            self._V if pred else 0, self._W if pred else 0,
            _i32p(self.wins) if pred else None,
        )
        if rc != 0:
            raise RuntimeError(f"ggrs_batch_stage failed: rc={rc}")

    def build(self, bb_out: np.ndarray) -> None:
        pred = self._predictor is not None
        rc = _core._lib.ggrs_batch_build(
            self._builders, self._S,
            _u8p(self.build_mask), _u8p(self.copy_mask), self._res_ptrs,
            _i32p(self.anchors), self._qs_ptrs,
            _u8p(self.known), _u8p(self.kmask),
            _u8p(self.seed_mask) if pred else None,
            _u8p(self.seed_traj) if pred else None,
            _u8p(self.seed_cand) if pred else None,
            _u8p(self._seed_valid) if pred else None,
            self._seed_hash if pred else 0, self._V if pred else 0,
            _u8p(bb_out),
            self.out_sigs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        )
        if rc != 0:
            raise RuntimeError(f"ggrs_batch_build failed: rc={rc}")


def make_batch_plane(
    input_spec, num_players: int, num_slots: int, num_branches: int,
    spec_frames: int, max_frames: int, predictor=None,
) -> Optional[NativeBatchPlane]:
    """NativeBatchPlane when the C++ core loads, the input dtype is in
    the native contract, and (if a predictor is bound) the payload is
    scalar per player — else None (per-slot dispatch path)."""
    if not _core.available():
        return None
    zero = np.asarray(input_spec.zeros_np(int(num_players)))
    if not _supported_dtype(zero.dtype):
        return None
    K = int(np.prod(zero.shape[1:], dtype=np.int64)) if zero.ndim > 1 else 1
    if predictor is not None and K != 1:
        return None
    return NativeBatchPlane(
        zero, num_players, num_slots, num_branches, spec_frames,
        max_frames, predictor,
    )


def match_prefix(
    branch_bits: np.ndarray, confirmed_bits: np.ndarray
) -> Optional[Tuple[int, int]]:
    """Native ``match_branch`` fast path: best (branch, leading-match
    depth) of ``confirmed_bits[k, ...]`` against ``branch_bits[B, F, ...]``.
    ``None`` when the core is unavailable or the dtypes fall outside the
    byte-comparable contract (caller keeps the NumPy path)."""
    if not _core.available():
        return None
    bb = np.asarray(branch_bits)
    cb = np.asarray(confirmed_bits)
    if bb.dtype != cb.dtype or bb.dtype.kind not in ("i", "u", "b"):
        return None
    B, F = int(bb.shape[0]), int(bb.shape[1])
    k = int(cb.shape[0])
    if k > F:
        return None
    frame_bytes = int(bb.nbytes // (B * F)) if B and F else 0
    if frame_bytes == 0 or (k and cb.nbytes // k != frame_bytes):
        return None
    branch = ctypes.c_int32()
    depth = ctypes.c_int32()
    _core._lib.ggrs_match_prefix(
        _u8p(_raw(bb)), B, F, frame_bytes, _u8p(_raw(cb)), k,
        ctypes.byref(branch), ctypes.byref(depth),
    )
    return int(branch.value), int(depth.value)
