"""Checkpointing: atomic, resumable.

Port of ``src/repro/checkpoint/ckpt.py``, in its format: one ``.npz`` with
'/'-joined tree paths as keys plus a json sidecar (step, keys, tree
structure).  Writes go to a temp file then ``os.replace`` (atomic on
POSIX), so a crash mid-write never corrupts the latest checkpoint.

A tree is nested dicts whose leaves are tensors or numpy arrays; the
port's train state is ``{"params": {name: tensor}, "opt": {"m": {...},
"v": {...}, "step": tensor}}`` (``launch.steps.state_tree``), so its keys
read ``params/blocks.0.attn.wq.w``.  A bfloat16 tensor is stored as f32
(exact) and restored to bfloat16.  ``restore`` puts each tensor leaf back
on the device and in the dtype of the ``like`` tree's leaf, where the
reference ``device_put``\\ s onto shardings.

``CheckpointManager`` adds keep-K retention, latest-step discovery and an
optional async writer thread (training never blocks on disk).  The port's
train step updates tensors in place, so ``CheckpointManager.save`` copies
every leaf to host numpy before it returns: the writer thread never sees
a later step's values.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch

Tree = Any
SEP = "/"


def _items(tree: Tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) of every leaf, depth first in dict order."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _items(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _map(fn, tree: Tree, prefix: Tuple[str, ...] = ()) -> Tree:
    if isinstance(tree, Mapping):
        return {k: _map(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    return fn(SEP.join(prefix), tree)


def to_host(x) -> np.ndarray:
    """A tensor leaf as a numpy copy (bfloat16 as f32); any other leaf as
    ``np.asarray`` gives it."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu", copy=True).numpy()
    return np.asarray(x)


def _structure(tree: Tree) -> str:
    if isinstance(tree, Mapping):
        return "{" + ", ".join(f"{k!r}: {_structure(v)}"
                               for k, v in tree.items()) + "}"
    return "*"


def save(path: str | Path, tree: Tree, step: int = 0) -> Path:
    """Atomic save; returns the final path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {SEP.join(p): to_host(x) for p, x in _items(tree)}
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **flat)
    meta = {"step": int(step), "keys": sorted(flat),
            "treedef": _structure(tree)}
    tmp_meta = path.with_suffix(".tmp.json")
    tmp_meta.write_text(json.dumps(meta))
    os.replace(tmp, path)
    os.replace(tmp_meta, path.with_suffix(".json"))
    return path


def restore(path: str | Path, like: Tree) -> Tree:
    """Restore into the structure of ``like``: a tensor leaf comes back as
    a tensor of its dtype on its device, any other leaf as a numpy array
    of its dtype."""
    with np.load(Path(path)) as data:
        def one(key, ref):
            if key not in data:
                raise KeyError(f"checkpoint missing key {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs {tuple(ref.shape)}")
            if isinstance(ref, torch.Tensor):
                return torch.from_numpy(arr).to(device=ref.device,
                                                dtype=ref.dtype)
            return arr.astype(ref.dtype)
        return _map(one, like)


def load_step(path: str | Path) -> int:
    meta = Path(path).with_suffix(".json")
    return int(json.loads(meta.read_text())["step"])


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3,
                 async_write: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._pending: Optional[threading.Thread] = None

    def _path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:08d}.npz"

    def steps(self) -> List[int]:
        return sorted(int(p.stem.split("_")[1]) for p in
                      self.dir.glob("ckpt_*.npz"))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def save(self, tree: Tree, step: int) -> None:
        # snapshot to host BEFORE handing to the writer thread: the next
        # train step updates the tensors in place
        host_tree = _map(lambda _, x: to_host(x), tree)

        def _write():
            save(self._path(step), host_tree, step)
            self._gc()

        self.wait()
        if self.async_write:
            self._pending = threading.Thread(target=_write, daemon=True)
            self._pending.start()
        else:
            _write()

    def restore_latest(self, like: Tree) -> Tuple[Optional[Tree], int]:
        step = self.latest_step()
        if step is None:
            return None, 0
        return restore(self._path(step), like), step

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            self._path(s).unlink(missing_ok=True)
            self._path(s).with_suffix(".json").unlink(missing_ok=True)
