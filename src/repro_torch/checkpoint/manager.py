"""Atomic, async checkpointing of nested containers of arrays.

Layout: one directory per step, one .npy per leaf (flattened tree paths
joined with "/"), plus a manifest.json with the leaves' files, shapes and
dtypes and the step.  Writes go to ``<dir>.tmp`` and are atomically
renamed -- a crash mid-save never corrupts the latest checkpoint
(restart reads the newest *complete* manifest).  The layout and the leaf
keys are the reference package's (``repro.checkpoint.manager``), so a
step directory written by either package loads in the other.

A tree is nested dicts (keys sorted, as the reference flattens them),
lists, tuples and named tuples (fields by name) whose leaves are numpy
arrays, tensors or scalars; ``None`` is an empty subtree.  Tensors are
copied to host numpy before anything is written, and an async save
snapshots the whole tree on the host before its thread starts, so the
thread never touches a device tensor.

Fault-tolerance properties exercised by tests:
  * atomic visibility (tmp-rename),
  * retention (keep_n) with never-delete-latest,
  * async save (background thread; ``wait()`` joins before the next save),
  * elastic restore (``restore_resharded``: each leaf placed on the
    device a tree of devices names, e.g. a survivor after a re-plan).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a container node, None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _flatten(tree) -> List[Tuple[str, Any]]:
    """``[(key, leaf)]`` in a fixed order; keys join the path with "/"."""
    out = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append(("/".join(path) or "leaf", node))
            return
        for k, c in kids:
            walk(c, path + [k])

    walk(tree, [])
    return out


def _unflatten(like, leaves: Dict[str, Any]):
    """A tree of ``like``'s structure with the leaves keyed by path."""
    def build(node, path):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return leaves["/".join(path) or "leaf"]
        vals = [build(c, path + [k]) for k, c in kids]
        if isinstance(node, dict):
            return dict(zip(sorted(node), vals))
        if _is_namedtuple(node):
            return type(node)(*vals)
        return type(node)(vals)

    return build(like, [])


def _host(leaf) -> np.ndarray:
    """A host numpy copy of a tensor (never a view of its memory);
    numpy arrays and scalars as ``np.asarray`` gives them."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _to_host(tree):
    """The same tree with every leaf as host numpy."""
    return _unflatten(tree, {k: _host(v) for k, v in _flatten(tree)})


def save_tree(tree, directory: str | Path, *, step: int,
              extra: Optional[Dict] = None) -> Path:
    """Synchronous atomic save of a tree of arrays."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {},
                "time": time.time()}
    for key, leaf in _flatten(tree):
        arr = _host(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][key] = {"file": fname,
                                   "shape": list(arr.shape),
                                   "dtype": str(arr.dtype)}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def load_tree(tree_like, directory: str | Path):
    """Load into the structure of ``tree_like`` as host numpy arrays
    (shapes must match)."""
    directory = Path(directory)
    manifest = json.loads((directory / "manifest.json").read_text())
    leaves = {}
    for key, like in _flatten(tree_like):
        info = manifest["leaves"][key]
        arr = np.load(directory / info["file"])
        want = tuple(like.shape) if hasattr(like, "shape") else None
        if want is not None and tuple(arr.shape) != want:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"expected {want}")
        leaves[key] = arr
    return _unflatten(tree_like, leaves)


def _place(like, devices, path, host, out) -> None:
    """Walk ``like`` beside ``devices``; put each leaf's host array on
    its device (a ``None`` device keeps it on the host).  A device at a
    container node covers every leaf below it."""
    if like is None:
        return
    kids = _children(like)
    key = "/".join(path) or "leaf"
    if kids is None:
        arr = host[key]
        out[key] = arr if devices is None else \
            torch.as_tensor(arr, device=torch.device(devices))
        return
    sub = _children(devices) if devices is not None else None
    if sub is None:                      # one device (or None) for all
        sub = [(k, devices) for k, _ in kids]
    sub = dict(sub)
    for k, c in kids:
        if k not in sub:
            raise ValueError(f"restore_resharded: no device for "
                             f"{'/'.join(path + [k])}")
        _place(c, sub[k], path + [k], host, out)


def restore_resharded(tree_like, directory: str | Path, devices):
    """Elastic restore: load into ``tree_like``'s structure and place
    every leaf on the device ``devices`` names for it.  ``devices`` is a
    tree like ``tree_like`` whose leaves are ``torch.device`` (or device
    strings), or ``None`` to keep the host numpy leaf; a single device
    covers a whole subtree."""
    host = dict(_flatten(load_tree(tree_like, directory)))
    out: Dict[str, Any] = {}
    _place(tree_like, devices, [], host, out)
    return _unflatten(tree_like, out)


class CheckpointManager:
    """Step-addressed checkpoints with retention + async save."""

    def __init__(self, directory: str | Path, keep_n: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- query --------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def path(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    # -- save ---------------------------------------------------------------
    def save(self, tree, step: int, *, extra: Optional[Dict] = None,
             block: bool = True):
        if block:
            save_tree(tree, self.dir, step=step, extra=extra)
            self._retain()
        else:
            self.wait()
            host = _to_host(tree)        # snapshot before the thread

            def work():
                try:
                    save_tree(host, self.dir, step=step, extra=extra)
                    self._retain()
                except BaseException as e:  # noqa: BLE001 - re-raised by wait
                    self._error = e

            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _retain(self):
        steps = self.steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self.path(s), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def restore_latest(self, tree_like, *, shardings=None):
        """``(tree, step)`` of the newest complete checkpoint, or ``(None,
        None)``.  ``shardings``: a devices tree for ``restore_resharded``;
        without it the leaves stay host numpy."""
        step = self.latest_step()
        if step is None:
            return None, None
        if shardings is not None:
            return restore_resharded(tree_like, self.path(step),
                                     shardings), step
        return load_tree(tree_like, self.path(step)), step
