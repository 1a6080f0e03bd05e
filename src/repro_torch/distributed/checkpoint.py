"""Atomic, self-validating snapshots of nested tensor trees (PyTorch port).

Every tensor is written as its whole host value (numpy ``.npy``) together
with a manifest describing the tree structure and step metadata, in the
JAX package's layout (``step_%08d/``, ``t%05d.npy``, ``manifest.json``,
``LATEST``): a snapshot written by either package loads in the other.

Snapshot protocol:
  1. write everything into ``step_N.tmp/`` — each tensor file fsynced, its
     size and sha256 digest recorded in the manifest
  2. fsync the manifest, atomically rename the directory to ``step_N/``,
     then fsync the parent directory (the rename itself must be durable)
  3. update the ``LATEST`` pointer file atomically and fsync the directory
     again, so the pointer survives power loss
A crash mid-write leaves only a ``.tmp`` directory, which restore ignores
and garbage-collects. A snapshot that *looks* final but fails validation
(bit rot, a lying fsync, a torn rename on a non-atomic filesystem) is
detected through the per-tensor digests, quarantined as ``step_N.corrupt``,
and restore falls back to the newest snapshot that validates — it raises
``CheckpointCorruptError`` rather than ever resuming from corrupt state.
``keep`` bounds disk usage.

Trees are nested dicts, lists and tuples; a leaf is a ``torch.Tensor``, a
numpy array or a scalar.  Keys are the ``/``-joined path (dict keys in
sorted order, list and tuple indices), e.g. ``"a/b/0"``.  ``restore``
returns torch tensors on the device it is given.

Fault injection: ``save(..., fault_plan=...)`` consults a
``core.runtime.faults.FaultPlan`` at the tensor-write, commit, and
post-commit points, so torn writes, kill-9-mid-save, and silent bit rot are
all reproducible test scenarios (see ``faults.torn_write`` / ``kill_write``
/ ``kill_commit`` / ``bitrot``).

In a ``torch.distributed`` group only rank 0 writes (concurrent same-step
writers would race the atomic renames) and every rank restores.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.runtime.faults import process_rank


class TornWriteError(RuntimeError):
    """An injected torn checkpoint write (stands in for the process dying
    mid-save; the real-death variant is ``faults.kill_write``)."""


class CheckpointCorruptError(RuntimeError):
    """A snapshot failed validation and no valid fallback exists."""


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in a fixed order: dict keys sorted, sequences by
    index; ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for name, sub in items:
        out.extend(_flatten(sub, f"{prefix}/{name}" if prefix else name))
    return out


def _unflatten(tree_like, leaves):
    """``tree_like``'s structure with its leaves taken in ``_flatten``
    order from the iterator ``leaves``."""
    if tree_like is None:
        return None
    if isinstance(tree_like, dict):
        filled = {k: _unflatten(tree_like[k], leaves) for k in sorted(tree_like)}
        return {k: filled[k] for k in tree_like}
    if isinstance(tree_like, (list, tuple)):
        seq = [_unflatten(v, leaves) for v in tree_like]
        return seq if isinstance(tree_like, list) else type(tree_like)(seq)
    return next(leaves)


def _whole(tree):
    """``tree`` with every DTensor leaf replaced by its whole tensor
    (``full_tensor``, in leaf order on every rank)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _whole(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        seq = [_whole(v) for v in tree]
        return seq if isinstance(tree, list) else type(tree)(seq)
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    return tree


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """(array np.save can write, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _fsync_dir(path: str) -> None:
    """Durably persist a directory's entry table (renames live there)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # e.g. a filesystem that cannot open directories
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _snap_name(step: int) -> str:
    return f"step_{step:08d}"


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None,
         keep: int = 3, fault_plan=None) -> str:
    """Atomic, digest-stamped snapshot of ``tree``.  Returns the final
    directory.  ``fault_plan`` optionally injects torn, killed or
    bit-rotted writes at the protocol's failure points (test harness).
    Only rank 0 writes; the values are whole on every rank, so skipping the
    write elsewhere loses nothing.  A DTensor leaf (a tree placed on a
    mesh) is gathered whole first, which is a collective: every rank calls
    ``save`` with the same tree."""
    tree = _whole(tree)
    if process_rank() != 0:
        return os.path.join(ckpt_dir, _snap_name(step))
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, _snap_name(step))
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "extra": extra or {}, "tensors": []}
    for i, (key, leaf) in enumerate(_flatten(tree)):
        arr, logical_dtype = _host_array(leaf)
        fname = f"t{i:05d}.npy"
        fpath = os.path.join(tmp, fname)
        with open(fpath, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        action = fault_plan.checkpoint_action(
            step=step, tensor=i, stage="tensor") if fault_plan else None
        if action is not None:
            with open(fpath, "r+b") as f:  # tear the write mid-file
                f.truncate(max(1, os.path.getsize(fpath) // 2))
            if action.kind == "kill_write":
                os._exit(137)  # the genuine kill -9: no cleanup, no atexit
            raise TornWriteError(
                f"injected torn write of tensor {i} at step {step}")
        manifest["tensors"].append(
            {"key": key, "file": fname, "dtype": logical_dtype,
             "shape": list(arr.shape), "bytes": os.path.getsize(fpath),
             "sha256": _file_sha256(fpath)}
        )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_dir(ckpt_dir)

    if fault_plan and fault_plan.checkpoint_action(
            step=step, stage="commit") is not None:
        os._exit(137)  # died after the snapshot rename, before the pointer

    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    _fsync_dir(ckpt_dir)

    if fault_plan:
        rot = fault_plan.checkpoint_action(step=step, stage="committed")
        if rot is not None:  # post-commit bit rot in tensor `rot.tensor`
            target = os.path.join(
                final, manifest["tensors"][rot.tensor]["file"])
            with open(target, "r+b") as f:
                f.seek(max(0, os.path.getsize(target) // 2))
                byte = f.read(1)
                f.seek(-1, os.SEEK_CUR)
                f.write(bytes([byte[0] ^ 0xFF]))

    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    snaps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith((".tmp", ".corrupt"))
    )
    for d in snaps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    gc_partial(ckpt_dir)


def gc_partial(ckpt_dir: str) -> None:
    """Sweep orphaned partial writes (``.tmp``) and quarantined corrupt
    snapshots (``.corrupt``). Called from both save *and* restore — a run
    that only ever restores must not accumulate its predecessors' debris."""
    try:
        entries = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return
    for d in entries:
        if d.endswith(".tmp") or d.endswith(".corrupt"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def validate_snapshot(snap_dir: str) -> List[str]:
    """Validate one snapshot directory; returns the list of problems
    (empty == valid). Checks the manifest parses and every tensor file
    exists with the recorded byte size and sha256 digest. Manifests without
    digests validate on existence alone."""
    problems: List[str] = []
    mpath = os.path.join(snap_dir, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        tensors = manifest["tensors"]
    except (OSError, ValueError, KeyError) as e:
        return [f"manifest unreadable: {e}"]
    for t in tensors:
        fpath = os.path.join(snap_dir, t["file"])
        if not os.path.exists(fpath):
            problems.append(f"missing tensor file {t['file']}")
            continue
        if "bytes" in t and os.path.getsize(fpath) != t["bytes"]:
            problems.append(
                f"{t['file']}: size {os.path.getsize(fpath)} != {t['bytes']}")
            continue
        if "sha256" in t and _file_sha256(fpath) != t["sha256"]:
            problems.append(f"{t['file']}: sha256 mismatch")
    return problems


def _quarantine(snap_dir: str) -> None:
    target = snap_dir + ".corrupt"
    if os.path.exists(target):
        shutil.rmtree(target, ignore_errors=True)
    try:
        os.replace(snap_dir, target)
    except OSError:
        shutil.rmtree(snap_dir, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The committed (pointer) step, if its manifest exists. Content is NOT
    validated here — use ``latest_valid_step`` for the self-checking path."""
    pointer = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def _step_of(name: str) -> Optional[int]:
    try:
        return int(name.split("_")[1])
    except (IndexError, ValueError):
        return None


def latest_valid_step(ckpt_dir: str) -> Optional[int]:
    """Newest snapshot that passes validation, quarantining any that fail.

    The committed (``LATEST``-pointed) snapshot is tried first; if it is
    torn or rotted it is renamed to ``step_N.corrupt`` and the scan falls
    back through the remaining snapshots newest-first (an unpointed but
    complete snapshot — crash between rename and pointer update — is
    restorable state and counts).  Returns ``None`` when the directory
    holds no snapshots at all; raises ``CheckpointCorruptError`` when
    snapshots exist but every one of them is corrupt — silently restarting
    from nothing would masquerade data loss as a fresh run.
    """
    if not os.path.isdir(ckpt_dir):
        return None
    gc_partial(ckpt_dir)  # stale .tmp debris is swept on restore, not just save
    candidates: List[str] = sorted(
        (d for d in os.listdir(ckpt_dir)
         if d.startswith("step_") and not d.endswith((".tmp", ".corrupt"))
         and _step_of(d) is not None),
        reverse=True,
    )
    pointer = os.path.join(ckpt_dir, "LATEST")
    if os.path.exists(pointer):
        with open(pointer) as f:
            name = f.read().strip()
        if name in candidates:  # pointer wins: it is the committed snapshot
            candidates.remove(name)
            candidates.insert(0, name)
    if not candidates:
        return None
    saw_corrupt = False
    for name in candidates:
        snap = os.path.join(ckpt_dir, name)
        if not validate_snapshot(snap):
            return _step_of(name)
        saw_corrupt = True
        _quarantine(snap)
    if saw_corrupt:
        raise CheckpointCorruptError(
            f"every snapshot in {ckpt_dir} failed validation — refusing to "
            "resume silently from corrupt state")
    return None


def load(ckpt_dir: str, step: Optional[int] = None):
    """Shape-agnostic raw load: ``(arrays_by_key, step, extra)`` or None,
    the arrays numpy on the host (a ``bfloat16`` tensor comes back as its
    ``uint16`` bits; ``restore`` reinterprets it).

    ``step=None`` resolves through ``latest_valid_step`` (corrupt snapshots
    are quarantined and the newest valid one wins). An explicit ``step``
    must validate or ``CheckpointCorruptError`` is raised — never a silent
    partial read.
    """
    if step is None:
        step = latest_valid_step(ckpt_dir)
        if step is None:
            return None
    snap = os.path.join(ckpt_dir, _snap_name(step))
    problems = validate_snapshot(snap)
    if problems:
        raise CheckpointCorruptError(
            f"snapshot {snap} failed validation: {problems}")
    with open(os.path.join(snap, "manifest.json")) as f:
        manifest = json.load(f)
    arrays: Dict[str, np.ndarray] = {}
    for t in manifest["tensors"]:
        arrays[t["key"]] = np.load(os.path.join(snap, t["file"]))
    return arrays, manifest["step"], manifest["extra"]


def restore(ckpt_dir: str, tree_like, step: Optional[int] = None,
            device="cuda", shardings=None, mesh=None):
    """Restore into the structure of ``tree_like`` as torch tensors on
    ``device`` (the card unless the caller asks for ``"cpu"``), each with
    its ``tree_like`` leaf's dtype.

    ``shardings``: optional matching tree of DTensor placements
    (``models.params.shardings``) with the ``mesh`` they are on — each
    leaf becomes a DTensor placed on the *current* mesh, whatever mesh
    saved it (elastic restart).  Every rank reads the whole snapshot and
    keeps its own shard, so placing needs no collective.

    Returns (tree, step, extra) or None if no snapshot exists.  Snapshots
    are digest-validated first: a corrupt newest snapshot falls back to the
    newest valid one, and corruption with no fallback raises
    ``CheckpointCorruptError`` (see ``latest_valid_step``).
    """
    from repro_torch.core.runtime.engine import resolve_device

    dev = resolve_device(device)
    out = load(ckpt_dir, step=step)
    if out is None:
        return None
    by_key, found_step, extra = out
    leaves = []
    for key, like in _flatten(tree_like):
        arr = by_key.get(key)
        if arr is None:
            raise KeyError(f"checkpoint missing tensor {key!r}")
        like_shape = tuple(like.shape) if hasattr(like, "shape") else ()
        if tuple(arr.shape) != like_shape:
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs {like_shape}")
        if isinstance(like, torch.Tensor):
            if like.dtype == torch.bfloat16:
                t = torch.from_numpy(arr.astype(np.uint16).view(np.int16))
                t = t.view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.ascontiguousarray(arr)).to(like.dtype)
        else:
            t = torch.from_numpy(np.ascontiguousarray(
                arr.astype(np.asarray(like).dtype)))
        leaves.append(t.to(dev))
    tree = _unflatten(tree_like, iter(leaves))
    if shardings is not None:
        if mesh is None:
            raise ValueError("restore(shardings=) needs the mesh they are on")
        from repro_torch.models.params import place

        tree = place(tree, mesh, shardings)
    return tree, found_step, extra
