"""Fault-tolerant checkpointing: atomic, async, in the reference's on-disk
format (counterpart of ``repro/train/checkpoint.py``).

Layout, leaf for leaf the reference's::

    <dir>/step_<N>/
        manifest.json        # step, leaf names, shapes, dtypes, crc, extra
        <leaf-path>.npy      # one file per leaf (full array)

A state is a nested dict whose leaves are arrays, tensors or numbers
(``None`` is an empty subtree, as in a JAX pytree); leaves are named by
their key path joined with ``/`` in sorted key order, as
``jax.tree_util`` flattens a dict.  A port train state goes in and out
through ``loop.state_to_numpy`` and ``loop.state_from_numpy``, which give
the JAX package's tree, so a checkpoint written by either package
restores in the other.

* Writes go to ``step_<N>.tmp`` then ``os.replace``: a crash mid-save can
  never corrupt the latest checkpoint (restore scans for complete dirs).
* ``save`` can write on a background thread (async): the state is copied
  to the host first, so training goes on while it is written.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.lm import to_host


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) in the order ``jax.tree_util`` flattens the tree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _host(x) -> np.ndarray:
    """A leaf as a host array: a tensor as a copy of its own (never a view
    of one that training goes on updating), an array as it is."""
    if isinstance(x, torch.Tensor):
        return to_host(x)
    return np.asarray(x)


def _map(tree, fn):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _safe(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_./-]", "_", name).replace("/", "__")


def _unflatten(pairs) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, arr in pairs:
        *path, last = name.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = arr
    return out


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------
    def save(self, step: int, state, extra: Optional[Dict] = None,
             async_: bool = False) -> None:
        host_state = _map(state, _host)
        # Always drain the previous async writer first: a sync save racing
        # an in-flight async save of the same step collides on the .tmp dir.
        self.wait()
        if async_:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_state, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host_state, extra or {})

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_state, extra: Dict) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": []}
        for name, arr in _flatten(host_state):
            fn = _safe(name) + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append({
                "name": name, "file": fn, "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "crc": hashlib.sha1(arr.tobytes()[:1 << 20]).hexdigest()[:12],
            })
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.dir, d,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like=None, step: Optional[int] = None
                ) -> Tuple[Dict[str, Any], Dict]:
        """(the state as a nested dict of numpy arrays, extra) of ``step``
        (default: the latest).  ``like``, a tree of the saved structure
        (values ignored), names the leaves to read: each must be in the
        checkpoint.  Without it every saved leaf is read."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        files = {m["name"]: m["file"] for m in manifest["leaves"]}
        names = list(files) if like is None else \
            [n for n, _ in _flatten(like)]
        missing = [n for n in names if n not in files]
        if missing:
            raise ValueError(f"checkpoint missing leaves: {missing[:5]}")
        state = _unflatten((n, np.load(os.path.join(d, files[n])))
                           for n in names)
        return state, manifest["extra"]
