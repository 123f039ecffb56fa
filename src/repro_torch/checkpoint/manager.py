"""Checkpoints with atomic commit, async writes, retention and restore onto
any devices.

The port of ``src/repro/checkpoint/manager.py``, in the same on-disk
format, so a checkpoint written by either package restores in the other::

    <dir>/step_000000123.tmp/          # staging (never read)
    <dir>/step_000000123/              # committed by an atomic rename
        manifest.json                  # step, process, n_processes, leaves, extra
        shard_p0.npz                   # the arrays, keyed by leaf path

A leaf's path joins dict keys and sequence indices with ``/`` (``0/layers/0/w``,
``1/m/layers/0/w``; ``optim/tree.py``), the reference's names.  The manifest
lists each leaf's shape and dtype.  numpy has no bfloat16 without
``ml_dtypes``, so a bf16 leaf is stored as its raw 2-byte values (numpy's
``V2``, what ``np.savez`` writes for the reference's bf16 arrays) under
dtype ``bfloat16``, and read back as those bits, from either package's
files.

* **Atomicity**: readers see only fully written checkpoints (a rename is
  atomic on POSIX); a crash mid-write leaves a ``.tmp`` that is ignored
  and removed by the next ``CheckpointManager``.
* **Restore onto devices**: ``restore(..., shardings=)`` takes a tree of
  ``torch.device``s (the port's single-controller counterpart of the
  reference's shardings) and places each leaf there; without it each leaf
  goes to the device of its counterpart in ``like_tree`` (the CPU for a
  non-tensor).
* **Async**: ``save_async`` copies the tree to host memory at once and
  writes it on a worker thread; ``wait`` joins, so at most one write is in
  flight.
* **Retention**: the ``keep`` newest checkpoints survive.

One process writes ``shard_p0.npz``: the port's mesh is single-controller.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.tree import flatten_with_paths, tree_map, unflatten

__all__ = ["CheckpointManager", "save", "restore", "latest_step"]

BF16 = "bfloat16"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:09d}")


def _committed_steps(ckpt_dir: str):
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            yield int(d.split("_")[1]), d


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [s for s, d in _committed_steps(ckpt_dir)
             if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf's host array and the dtype the manifest names."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(ckpt_dir: str, step: int, tree, *, extra: Optional[Dict] = None) -> str:
    """Synchronous atomic save of a tree of tensors (or numpy arrays)."""
    flat, _ = flatten_with_paths(tree)
    tmp = _step_dir(ckpt_dir, step) + ".tmp"
    final = _step_dir(ckpt_dir, step)
    os.makedirs(tmp, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "process": 0, "n_processes": 1, "leaves": {},
                "extra": extra or {}}
    for name, leaf in flat:
        arr, dtype = _to_numpy(leaf)
        arrays[name] = arr
        manifest["leaves"][name] = {"shape": list(arr.shape), "dtype": dtype}
    np.savez(os.path.join(tmp, "shard_p0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def restore(ckpt_dir: str, step: int, like_tree, *, shardings=None):
    """Restore into the structure of ``like_tree``; each leaf on the
    matching device of ``shardings`` (a tree of ``torch.device``s or device
    names) or, without it, on the device of its ``like_tree`` leaf."""
    path = _step_dir(ckpt_dir, step)
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = {k: v["dtype"] for k, v in json.load(f)["leaves"].items()}
    with np.load(os.path.join(path, "shard_p0.npz")) as z:
        data = {k: z[k] for k in z.files}
    flat, spec = flatten_with_paths(like_tree)
    if shardings is not None:
        devices = [d for _, d in flatten_with_paths(shardings)[0]]
        if len(devices) != len(flat):
            raise ValueError(f"restore: {len(devices)} devices for {len(flat)} leaves")
    else:
        devices = [leaf.device if torch.is_tensor(leaf) else "cpu" for _, leaf in flat]
    missing = [name for name, _ in flat if name not in data]
    if missing:
        raise KeyError(f"restore: step {step} holds no leaf {missing[:3]}")
    return unflatten(spec, [_to_tensor(data[name], dtypes.get(name, "")).to(dev)
                            for (name, _), dev in zip(flat, devices)])


def host_copy(tree):
    """Every tensor leaf copied to host memory (never aliasing the leaf,
    even one already on the CPU)."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True) if torch.is_tensor(x) else x, tree)


class CheckpointManager:
    """Async, retention-managed checkpointing for the training loop."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._gc_stale()

    def _gc_stale(self):
        for d in os.listdir(self.dir):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def _gc_old(self):
        steps = sorted(s for s, _ in _committed_steps(self.dir))
        for s in steps[: -self.keep]:
            shutil.rmtree(_step_dir(self.dir, s), ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree, *, extra: Optional[Dict] = None):
        """Copy to host now; write on a worker thread (one in flight)."""
        self.wait()
        host_tree = host_copy(tree)

        def work():
            save(self.dir, step, host_tree, extra=extra)
            self._gc_old()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_sync(self, step: int, tree, *, extra: Optional[Dict] = None) -> str:
        self.wait()
        p = save(self.dir, step, tree, extra=extra)
        self._gc_old()
        return p

    def restore_latest(self, like_tree, *, shardings=None) -> Tuple[Optional[int], Any]:
        self.wait()
        step = latest_step(self.dir)
        if step is None:
            return None, like_tree
        return step, restore(self.dir, step, like_tree, shardings=shardings)
