"""Numpy checkpointing of torch trees: atomic, async, keep-last-k,
resumable, in the reference's layout.

Port of ``repro.ckpt.checkpoint``.  Layout, as the reference writes it:

          <dir>/step_<N>/ {manifest.json, leaf_<i>.npy ...}
          <dir>/LATEST  (atomic pointer file)

The leaves are numbered in JAX's flatten order (dict keys sorted, lists in
order: `repro_torch.tree`), so a checkpoint written by either package
restores in the other: a train state ``{"params", "opt": {"m", "v",
"step"}}`` is ``opt.m``'s leaves, ``opt.step``, ``opt.v``'s, then
``params``'s, in both.  Leaves are copied to the host as numpy arrays in
their own dtype; a bf16 leaf is written in the reference's numpy dtype
(``ml_dtypes.bfloat16``, imported only then), and a bf16 leaf comes back
from ``np.load`` as 2-byte void, which restores as bf16 bytes.

Writes go to a tmp dir first and are renamed into place, so a pilot killed
mid-write can never corrupt the latest checkpoint.  Overwriting an
existing ``step_N`` never deletes before the replacement is in place: the
old dir is renamed aside (``.retired_step_N_*``), the tmp dir renamed in,
and only then is the retired dir removed; ``_sweep_retired`` (run by
``save``/``latest_step``/``all_steps``) renames an orphaned retired dir
back into place, so ``latest_step`` always resolves to a restorable
checkpoint.  ``restore`` validates leaf dtypes as well as shapes; pass
``cast=True`` to convert explicitly.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch.analysis.locks import make_lock

_RETIRED_PREFIX = ".retired_step_"
_NUMPY = {torch.float32: np.dtype(np.float32), torch.float64: np.dtype(np.float64),
          torch.float16: np.dtype(np.float16), torch.int32: np.dtype(np.int32),
          torch.int64: np.dtype(np.int64), torch.int8: np.dtype(np.int8),
          torch.uint8: np.dtype(np.uint8), torch.bool: np.dtype(np.bool_)}


def _bf16_numpy():
    import ml_dtypes                   # the reference's numpy bfloat16
    return np.dtype(ml_dtypes.bfloat16)


def snapshot(tree):
    """``tree`` with every leaf copied to a host numpy array: the device
    part of a save, which a caller can take under its device lock and
    hand to `save` (or `AsyncCheckpointer.save`) to write."""
    return tree_mod.map_leaves(_host, tree)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array in its own dtype (a copy: the train
    loop updates its tensors in place while an async save writes)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_bf16_numpy())
    return t.numpy()


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return _bf16_numpy() if dtype == torch.bfloat16 else _NUMPY[dtype]


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Blocking save of a tree of tensors (or numpy arrays).  Returns the
    checkpoint path."""
    leaves = tree_mod.leaves(tree)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}_{os.getpid()}_{threading.get_ident()}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": tree_mod.structure(tree),
                "n_leaves": len(leaves), "time": time.time()}
    for i, leaf in enumerate(leaves):
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), _host(leaf))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        # never a moment without a complete step_N on disk: retire the old
        # dir aside, move the new one in, THEN delete.  The retire TIME
        # rides in the name (rename preserves mtime), for the sweep's
        # live-writer grace window.
        retired = os.path.join(
            ckpt_dir,
            f"{_RETIRED_PREFIX}{step}_{int(time.time() * 1000)}"
            f"_{os.getpid()}_{threading.get_ident()}")
        os.rename(final, retired)
        os.rename(tmp, final)
        shutil.rmtree(retired, ignore_errors=True)
    else:
        os.rename(tmp, final)
    _point_latest(ckpt_dir, step)
    _gc(ckpt_dir, keep)        # its all_steps() listing also runs the sweep
    return final


def _sweep_retired(ckpt_dir: str, *, min_age_s: float = 2.0):
    """Crash recovery for the overwrite window: a ``.retired_step_N_*`` dir
    whose ``step_N`` is missing means the writer died between the two
    renames — put the old (complete) checkpoint back, but only once it was
    retired more than ``min_age_s`` ago (a fresh one most likely belongs
    to a live writer mid-window).  If ``step_N`` exists, the retired dir is
    garbage."""
    if not os.path.isdir(ckpt_dir):
        return
    for d in os.listdir(ckpt_dir):
        if not d.startswith(_RETIRED_PREFIX):
            continue
        parts = d[len(_RETIRED_PREFIX):].split("_")
        try:
            step = int(parts[0])
            retired_at = int(parts[1]) / 1000.0
        except (ValueError, IndexError):
            continue
        path = os.path.join(ckpt_dir, d)
        final = os.path.join(ckpt_dir, f"step_{step}")
        try:
            if os.path.isdir(final):
                shutil.rmtree(path, ignore_errors=True)
            elif time.time() - retired_at >= min_age_s:
                os.rename(path, final)
        except OSError:
            continue                       # a concurrent sweeper (or the
                                           # writer itself) won the rename


def _point_latest(ckpt_dir: str, step: int):
    tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(ckpt_dir, "LATEST"))


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    _sweep_retired(ckpt_dir)
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.startswith(".tmp"):
            try:
                out.append(int(d.split("_", 1)[1]))
            except ValueError:
                pass
    return out


def latest_step(ckpt_dir: str) -> int | None:
    _sweep_retired(ckpt_dir)
    p = os.path.join(ckpt_dir, "LATEST")
    if os.path.exists(p):
        try:
            with open(p) as f:
                s = int(f.read().strip())
            if os.path.isdir(os.path.join(ckpt_dir, f"step_{s}")):
                return s
        except ValueError:
            pass
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def _leaf_tensor(arr: np.ndarray, ref: torch.Tensor, i: int, cast: bool):
    """Leaf ``i`` of a checkpoint as a tensor of ``ref``'s dtype on its
    device; a dtype other than ``ref``'s raises unless ``cast``."""
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"leaf {i}: ckpt shape {arr.shape} != {tuple(ref.shape)}")
    if ref.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 and (
            arr.dtype.kind == "V" or arr.dtype == _bf16_numpy()):
        t = torch.from_numpy(np.require(arr, requirements="C").view(np.int16))
        return t.view(torch.bfloat16).to(ref.device)
    want = _np_dtype(ref.dtype)
    if arr.dtype != want:
        if not cast:
            raise ValueError(
                f"leaf {i}: ckpt dtype {arr.dtype} != expected {want} "
                f"(pass cast=True to convert explicitly)")
        if ref.dtype == torch.bfloat16:
            return torch.from_numpy(arr.astype(np.float32)).to(
                device=ref.device, dtype=torch.bfloat16)
        arr = arr.astype(want)
    return torch.from_numpy(np.require(arr, requirements="C")).to(ref.device)


def restore(ckpt_dir: str, step: int, like, *, cast: bool = False):
    """Restore into the structure of ``like`` (a tree of tensors): a new
    tree of tensors, each of its ``like`` leaf's dtype on its device.

    Leaf shapes AND dtypes must match ``like``; a dtype mismatch raises
    unless ``cast=True`` opts into an explicit conversion."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    out = []
    for i, ref in enumerate(tree_mod.leaves(like)):
        arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
        out.append(_leaf_tensor(arr, ref, i, cast))
    return tree_mod.unflatten(like, out)


class AsyncCheckpointer:
    """Fire-and-forget background saves; at most one in flight (newer saves
    queue behind; superseded queued saves are dropped)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._lock = make_lock("ckpt.async-writer")
        self._pending: tuple[int, object] | None = None
        self._thread: threading.Thread | None = None
        self._running = False       # exit/restart decisions share the lock
        self.errors: list[Exception] = []

    def save(self, step: int, tree):
        # snapshot to host synchronously (cheap vs device compute), write async
        snap = snapshot(tree)
        with self._lock:
            self._pending = (step, snap)
            if not self._running:
                self._running = True
                self._thread = threading.Thread(target=self._drain, daemon=True)
                self._thread.start()

    def _drain(self):
        while True:
            with self._lock:
                item, self._pending = self._pending, None
                if item is None:
                    self._running = False
                    return
            try:
                save(self.ckpt_dir, item[0], item[1], keep=self.keep)
            except Exception as e:      # surfaced via .errors + wait()
                self.errors.append(e)

    def wait(self):
        t = self._thread
        if t is not None:
            t.join()
        if self.errors:
            raise self.errors[-1]
