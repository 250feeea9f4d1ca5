"""Disk checkpoint / resume for rollback sessions, in the JAX package's bytes.

Counterpart of ``bevy_ggrs_tpu/utils/persistence.py``. The runner's
resumable state (world, snapshot ring, frame counter) persists as one atomic
``.npz`` file, and :class:`CheckpointManager` keeps the last K of a live
session. The supervisor ships the same bytes between peers as state
transfers, so a checkpoint written here loads into the JAX package and the
other way round, and both packages write equal bytes for equal worlds:

- every leaf is keyed by the path string ``jax.tree_util.keystr`` gives it
  (``['ring'].states.components['translation']``): dict keys sorted,
  sequences by position, a dataclass's fields in declaration order;
- the leaves are ``leaf_{i}`` arrays beside a JSON header
  ``{"version": 2, "paths": [...], "metadata": {...}}`` under
  ``__ggrs_header__``, zipped as ``np.savez_compressed`` does;
- a ring's checksums are ``uint32[depth, 2]`` on disk (the port holds them
  as ``int64`` lanes) and a bfloat16 leaf is its 2-byte patterns under the
  descr ``<V2``, which is what JAX's ``np.asarray`` of a bfloat16 array
  saves. numpy loads that back as ``V2``, which is no template's dtype, so
  neither package loads a checkpoint holding a bfloat16 leaf.

Restore validates path, shape and dtype against a template the caller
builds (schedules are code, not data), so a checkpoint of another registry
or capacity fails loudly, and every loaded leaf is a fresh tensor on the
template leaf's device.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import tempfile
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bevy_ggrs_tpu_torch.state import SnapshotRing, WorldState, np_dtype, to_numpy

_HEADER_KEY = "__ggrs_header__"
# v2: SnapshotRing.checksums widened from uint32[depth] to uint32[depth, 2]
# (two independent 64-bit lanes). A v1 checkpoint's ring no longer matches
# any current template, so v1 fails the version gate with an explicit
# message instead of a generic per-leaf shape mismatch.
_FORMAT_VERSION = 2
# The npy descr JAX's bfloat16 arrays are saved under (ml_dtypes' dtype).
_BF16_DESCR = "<V2"


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One leaf of a checkpoint tree: its path string, the value, and
    whether it is a ring's ``int64`` lanes (``uint32`` on disk)."""

    path: str
    value: Any
    lanes: bool = False


def _flatten(tree, path: str = "") -> List[_Leaf]:
    """The leaves of ``tree`` in ``jax.tree_util.tree_flatten_with_path``'s
    order, each with its ``keystr``. ``None`` is an empty subtree."""
    if isinstance(tree, SnapshotRing):
        return (_flatten(tree.states, path + ".states")
                + _flatten(tree.frames, path + ".frames")
                + [_Leaf(path + ".checksums", tree.checksums, lanes=True)])
    if isinstance(tree, WorldState):
        return [leaf for f in dataclasses.fields(WorldState)
                for leaf in _flatten(getattr(tree, f.name), f"{path}.{f.name}")]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, t in enumerate(tree) for leaf in _flatten(t, f"{path}[{i}]")]
    if tree is None:
        return []
    return [_Leaf(path, tree)]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(template, SnapshotRing):
        states = _unflatten(template.states, leaves)
        frames = _unflatten(template.frames, leaves)
        return SnapshotRing(states=states, frames=frames, checksums=next(leaves))
    if isinstance(template, WorldState):
        return WorldState(**{f.name: _unflatten(getattr(template, f.name), leaves)
                             for f in dataclasses.fields(WorldState)})
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(t, leaves) for t in template)
    if template is None:
        return None
    return next(leaves)


def _host(leaf: _Leaf) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf's host array as JAX's ``np.asarray`` would save it, and the
    npy descr to write when numpy cannot name it (bfloat16)."""
    v = leaf.value
    if not isinstance(v, torch.Tensor):
        return np.asarray(v), None
    if leaf.lanes:
        return to_numpy(v).astype(np.uint32), None
    a = to_numpy(v)
    if v.dtype == torch.bfloat16:
        return a, _BF16_DESCR
    return a, None


def _expected(leaf: _Leaf) -> Tuple[Any, str]:
    """(numpy dtype or None, printed name) a template leaf requires on
    disk. A bfloat16 leaf has no numpy dtype: nothing loads into it."""
    v = leaf.value
    if not isinstance(v, torch.Tensor):
        dt = np.asarray(v).dtype
        return dt, str(dt)
    if leaf.lanes:
        return np.dtype(np.uint32), "uint32"
    if v.dtype == torch.bfloat16:
        return None, "bfloat16"
    dt = np_dtype(v.dtype)
    return dt, str(dt)


def _write_npz(members: Dict[str, Tuple[np.ndarray, Optional[str]]]) -> bytes:
    """``np.savez_compressed``'s bytes for ``members`` (name -> array and
    descr override): the same zip entries, flags and npy headers."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, mode="w", compression=zipfile.ZIP_DEFLATED,
                         allowZip64=True) as zf:
        for key, (arr, descr) in members.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if descr is None:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                else:
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": descr, "fortran_order": False, "shape": arr.shape})
                    f.write(np.ascontiguousarray(arr).tobytes())
    return buf.getvalue()


def dumps_checkpoint(tree, metadata: Optional[Dict] = None) -> bytes:
    """Serialize ``tree`` (a world, a ring, or dicts, lists and tuples of
    tensors and arrays) and ``metadata`` to checkpoint bytes (what
    :func:`save_checkpoint` writes). The supervisor's state transfer ships
    these bytes over the wire."""
    leaves = _flatten(tree)
    members = {f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)}
    header = json.dumps({
        "version": _FORMAT_VERSION,
        "paths": [leaf.path for leaf in leaves],
        "metadata": metadata or {},
    })
    members[_HEADER_KEY] = (np.frombuffer(header.encode(), dtype=np.uint8), None)
    return _write_npz(members)


def save_checkpoint(path: str, tree, metadata: Optional[Dict] = None) -> None:
    """Write ``tree`` and ``metadata`` atomically to ``path`` (``.npz``):
    through a temporary file and a rename, so a crash mid-write never
    leaves a truncated checkpoint behind."""
    blob = dumps_checkpoint(tree, metadata)
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _load_leaf(arr: np.ndarray, leaf: _Leaf):
    """A fresh tensor (or array, for an array template) holding ``arr``,
    of the template leaf's dtype and on its device."""
    v = leaf.value
    if not isinstance(v, torch.Tensor):
        return torch.from_numpy(np.array(arr))
    if leaf.lanes:
        return torch.from_numpy(arr.astype(np.int64)).to(v.device)
    return torch.from_numpy(np.array(arr)).to(v.device)


def _validate_and_unflatten(data, template, name: str) -> Tuple[Any, Dict]:
    header = json.loads(bytes(data[_HEADER_KEY]).decode())
    # v1 is not rejected outright: the checksum widening shipped before the
    # version bump, so v1 checkpoints exist in both layouts. A v1 file whose
    # leaves validate loads; one whose ring checksums mismatch gets the
    # explicit legacy error below.
    legacy_v1 = header.get("version") == 1
    if not legacy_v1 and header.get("version") != _FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {name!r}: format version "
            f"{header.get('version')} != {_FORMAT_VERSION}"
        )
    t_leaves = _flatten(template)
    t_paths = [leaf.path for leaf in t_leaves]
    if header["paths"] != t_paths:
        missing = set(t_paths) - set(header["paths"])
        extra = set(header["paths"]) - set(t_paths)
        raise ValueError(
            f"checkpoint {name!r} does not match template: "
            f"missing={sorted(missing)} extra={sorted(extra)}"
        )
    loaded = []
    for i, leaf in enumerate(t_leaves):
        arr = data[f"leaf_{i}"]
        dtype, dtype_name = _expected(leaf)
        shape = tuple(leaf.value.shape) if isinstance(leaf.value, torch.Tensor) \
            else np.shape(leaf.value)
        if arr.shape != shape or dtype is None or arr.dtype != dtype:
            if legacy_v1 and "checksums" in leaf.path and arr.ndim + 1 == len(shape):
                raise ValueError(
                    f"checkpoint {name!r} predates 64-bit checksums "
                    f"(leaf {leaf.path} is {list(arr.shape)}, now "
                    f"uint32[depth, 2]) — re-save from a current "
                    "session; pre-widening checkpoints cannot resume"
                )
            raise ValueError(
                f"checkpoint leaf {leaf.path}: {arr.dtype}{list(arr.shape)} != "
                f"template {dtype_name}{list(shape)}"
            )
        loaded.append(_load_leaf(arr, leaf))
    return _unflatten(template, iter(loaded)), header["metadata"]


def _members(data: bytes, name: str) -> Dict[str, np.ndarray]:
    """Every array of checkpoint bytes, decoded. Bytes damaged anywhere (the
    zip's structure, a member's CRC or deflate stream, an npy header) raise
    ValueError naming the checkpoint: the zip and npy readers raise a dozen
    types for damage (BadZipFile, zlib.error, NotImplementedError for a
    compression method, RuntimeError for an encryption flag, ...)."""
    try:
        with np.load(io.BytesIO(data)) as npz:
            return {k: npz[k] for k in npz.files}
    except Exception as e:
        raise ValueError(f"checkpoint {name!r} is damaged: {type(e).__name__}: {e}") from e


def loads_checkpoint(data: bytes, template, name: str = "<bytes>") -> Tuple[Any, Dict]:
    """Inverse of :func:`dumps_checkpoint`: parse checkpoint bytes into the
    structure of ``template`` with full path/shape/dtype validation (wire
    payloads are as untrusted as disk files). ``name`` labels errors."""
    return _validate_and_unflatten(_members(data, name), template, name)


def load_checkpoint(path: str, template) -> Tuple[Any, Dict]:
    """Read a checkpoint into the structure of ``template``; returns
    ``(tree, metadata)``. Every leaf is validated against the template's
    path, shape and dtype before any device transfer."""
    with open(path, "rb") as f:
        return loads_checkpoint(f.read(), template, path)


# ---------------------------------------------------------------------------
# Runner integration
# ---------------------------------------------------------------------------


def _runner_meta(runner, metadata: Optional[Dict], session) -> Dict:
    meta = dict(metadata or {})
    meta.update(
        frame=runner.frame,
        rollbacks_total=runner.rollbacks_total,
        rollback_frames_total=runner.rollback_frames_total,
    )
    if session is not None:
        meta["session_state"] = session.state_dict()
    return meta


def runner_tree(runner) -> Dict:
    """The runner's world and ring, whole: gathered from every rank's rows
    when the runner is entity-sharded (``RollbackRunner.whole_state``), so
    a checkpoint is the same file with and without a mesh."""
    if not hasattr(runner, "whole_state"):
        return {"state": runner.state, "ring": runner.ring}
    return {"state": runner.whole_state(), "ring": runner.whole_ring()}


def save_runner(path: str, runner, metadata: Optional[Dict] = None, session=None) -> None:
    """Persist a runner's resumable state (world, ring, frame, rollback
    counters). Pass the driving ``session`` too: its frame counter and
    in-window input and checksum history are part of the resumable whole,
    and a session restarted at frame 0 beside a restored runner breaks the
    save-frame invariant at once."""
    save_checkpoint(path, runner_tree(runner), _runner_meta(runner, metadata, session))


def dumps_runner(runner, metadata: Optional[Dict] = None, session=None) -> bytes:
    """:func:`save_runner` to bytes: the full checkpoint a healthy peer
    serves a restarted one (``STATE_KIND_FULL`` in the supervisor's state
    transfer)."""
    return dumps_checkpoint(runner_tree(runner), _runner_meta(runner, metadata, session))


def _apply_runner(tree, meta: Dict, runner, session) -> Dict:
    frame = int(meta["frame"])
    if session is not None:
        sd = meta.get("session_state")
        if sd is None:
            raise ValueError(
                "checkpoint carries no session state; save with "
                "save_runner(..., session=...) to resume a session"
            )
        backup = session.state_dict()
        try:
            session.load_state_dict(sd)
        except BaseException:
            session.load_state_dict(backup)
            raise
    # Plain attribute assignment from here on: nothing can raise, so runner
    # and session move to the checkpointed frame together.
    if hasattr(runner, "adopt"):
        runner.adopt(tree["state"], tree["ring"])  # this rank's rows on a mesh
    else:
        runner.state = tree["state"]
        runner.ring = tree["ring"]
    runner.frame = frame
    runner.rollbacks_total = int(meta.get("rollbacks_total", 0))
    runner.rollback_frames_total = int(meta.get("rollback_frames_total", 0))
    # A speculative runner's pending rollout and logs describe the world
    # before the restore: a later rollback must not commit branches from it.
    invalidate = getattr(runner, "invalidate_speculation", None)
    if invalidate is not None:
        invalidate()
    return meta


def restore_runner(path: str, runner, session=None) -> Dict:
    """Restore ``runner`` (and ``session``, when given) in place from
    :func:`save_runner` output; the runner must have the checkpoint's
    registry, capacity and ``max_prediction`` (validation enforces it).
    Returns the saved metadata.

    All or nothing: everything that can raise (validation, the frame, the
    session's restore) happens before the first runner field is assigned,
    and a failing session restore puts the session back as it was, so a
    caller falling back to an older checkpoint never sees a runner at frame
    N beside a session at frame 0."""
    tree, meta = load_checkpoint(path, runner_tree(runner))
    return _apply_runner(tree, meta, runner, session)


def loads_runner(data: bytes, runner, session=None) -> Dict:
    """:func:`restore_runner` from :func:`dumps_runner` bytes: the receiving
    half of the supervisor's full-checkpoint transfer, all or nothing."""
    tree, meta = loads_checkpoint(data, runner_tree(runner), "<transfer>")
    return _apply_runner(tree, meta, runner, session)


# ---------------------------------------------------------------------------
# Rolling checkpoint manager
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Rolling on-disk checkpoints of a live session.

    ``maybe_save(runner)`` writes every ``interval`` frames and prunes to the
    ``keep`` most recent; ``restore_latest(runner)`` resumes from the newest
    intact checkpoint, skipping any that fail to load or validate."""

    _NAME = re.compile(r"^ckpt_(\d+)\.npz$")

    def __init__(self, directory: str, interval: int = 60, keep: int = 3):
        if interval <= 0 or keep <= 0:
            raise ValueError("interval and keep must be positive")
        self.directory = directory
        self.interval = int(interval)
        self.keep = int(keep)
        os.makedirs(directory, exist_ok=True)

    def _checkpoints(self) -> List[Tuple[int, str]]:
        out = []
        for name in os.listdir(self.directory):
            m = self._NAME.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.directory, name)))
        return sorted(out)

    def maybe_save(self, runner, metadata: Optional[Dict] = None,
                   session=None) -> Optional[str]:
        """Checkpoint iff ``runner.frame`` is an ``interval`` boundary not
        yet saved; returns the path when one was written."""
        frame = runner.frame
        if frame == 0 or frame % self.interval:
            return None
        path = os.path.join(self.directory, f"ckpt_{frame}.npz")
        if os.path.exists(path):
            return None
        save_runner(path, runner, metadata, session=session)
        for _, stale in self._checkpoints()[: -self.keep]:
            os.unlink(stale)
        return path

    def restore_latest(self, runner, session=None) -> Optional[Dict]:
        """Restore the newest checkpoint that loads and validates against
        ``runner``; returns its metadata, or None when none is usable."""
        for _, path in reversed(self._checkpoints()):
            try:
                return restore_runner(path, runner, session=session)
            except (ValueError, OSError, KeyError):
                # A damaged file is a ValueError here (_members); JAX's
                # loader lets the zip reader's own errors escape its
                # manager instead.
                continue
        return None
