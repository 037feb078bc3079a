"""Checkpoint/restart in the reference's on-disk format.

Layout per step:  <dir>/step_<N>/arrays.npz + manifest.json, committed by
atomic directory rename (write to ``.tmp-step_<N>``, fsync, ``os.replace``)
so a killed process never leaves a half-written checkpoint visible.

The format is the JAX reference's (``repro/ckpt/checkpoint.py``), so a
checkpoint written by either package restores in the other: leaves are
named by their path joined with ``/`` in ``jax.tree`` order (dict keys
sorted, NamedTuple fields by name, sequence items by index —
:mod:`repro_torch.tree` visits the same way), stored unsharded on the host,
and a bf16 leaf is stored as its ``uint16`` bits and marked ``"bfloat16"``
in the manifest.  bf16 is read back through torch (an ``int16`` tensor
viewed as ``torch.bfloat16``): no ``ml_dtypes`` is needed.

``restore`` places every leaf on one device (``None``: ``cuda:0``, or an
error without a card).  ``AsyncCheckpointer`` copies to the host on the
caller's thread, after a synchronise, and writes in a background thread,
overlapping I/O with compute.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tree as tree_util
from ..device import DeviceLike, resolve_device


def _flatten_with_names(tree: Any) -> List[Tuple[str, Any]]:
    return [("/".join(str(k) for k in path), leaf)
            for path, leaf in tree_util.leaves_with_path(tree)]


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as the array stored and the dtype name of the manifest."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _step_of(name: str) -> Optional[int]:
    """Step number of a ``step_<N>`` directory name, None for anything else
    (foreign files, half-named junk — never an exception on listdir noise)."""
    if not name.startswith("step_"):
        return None
    try:
        return int(name.split("_", 1)[1])
    except (IndexError, ValueError):
        return None


def _sweep_tmp(ckpt_dir: str, keep: Optional[str] = None) -> None:
    """Remove ``.tmp-step_*`` leftovers from a killed writer (they are, by
    construction, uncommitted — ``os.replace`` either ran or didn't)."""
    for name in os.listdir(ckpt_dir):
        if not name.startswith(".tmp-step_"):
            continue
        path = os.path.join(ckpt_dir, name)
        if keep is not None and os.path.abspath(path) == os.path.abspath(keep):
            continue
        shutil.rmtree(path, ignore_errors=True)


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` (tensors on any device, or NumPy arrays) as step
    ``step``; returns the committed directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    _sweep_tmp(ckpt_dir, keep=tmp)
    os.makedirs(tmp)
    named = _flatten_with_names(tree)
    arrays, dtypes = {}, {}
    for name, leaf in named:
        arrays[name], dtypes[name] = _to_numpy(leaf)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "n_arrays": len(arrays),
        "names": [n for n, _ in named],
        "dtypes": dtypes,
        "n_devices_at_save": max(torch.cuda.device_count(), 1),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [s for s in (_step_of(d) for d in os.listdir(ckpt_dir))
             if s is not None]
    return max(steps) if steps else None


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None,
            device: DeviceLike = None) -> Tuple[Any, Dict[str, Any]]:
    """Load into the structure of ``tree_like`` (its leaves give the names
    and shapes; tensors or ``meta`` tensors); every leaf goes to
    ``device``.  Returns ``(tree, manifest)``."""
    device = resolve_device(device)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    named = _flatten_with_names(tree_like)
    have = [n for n, _ in named]
    want = manifest["names"]
    if have != want:
        missing = [n for n in want if n not in have]
        unexpected = [n for n in have if n not in want]
        raise ValueError(
            f"checkpoint tree structure mismatch at step {step} in "
            f"{ckpt_dir!r}: checkpoint has {len(want)} leaves, tree_like has "
            f"{len(have)}; missing from tree_like: {missing[:5]!r}; "
            f"unexpected in tree_like: {unexpected[:5]!r}")
    dtypes = manifest.get("dtypes", {})
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for name, like in named:
            arr = data[name]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(
                    f"checkpoint leaf {name!r} at step {step}: stored shape "
                    f"{tuple(arr.shape)} != target shape {tuple(like.shape)}")
            if dtypes.get(name) == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            leaves.append(t.to(device))
    tree = tree_util.unflatten(tree_util.structure(tree_like), leaves)
    return tree, manifest


def prune(ckpt_dir: str, keep: int = 3) -> None:
    steps = sorted(s for s in (_step_of(d) for d in os.listdir(ckpt_dir))
                   if s is not None)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"))


class AsyncCheckpointer:
    """Snapshot-to-host now, write in background; at most one pending write."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        for dev in {t.device for t in tree_util.leaves(tree)
                    if isinstance(t, torch.Tensor) and t.is_cuda}:
            torch.cuda.synchronize(dev)
        host_tree = tree_util.map(
            lambda t: t.detach().to("cpu", copy=True)
            if isinstance(t, torch.Tensor) else np.array(t), tree)

        def _write():
            try:
                save(self.ckpt_dir, step, host_tree, extra)
                prune(self.ckpt_dir, self.keep)
            except Exception as e:     # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the pending write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
