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
* On several ranks the state's DTensor leaves are gathered whole by
  ``loop.state_to_numpy`` (every rank calls it), rank 0 alone writes,
  and :meth:`Checkpointer.wait` holds every rank until the write is
  done.  ``restore(shardings=)`` gives each rank its shard of each full
  array, read from the ``.npy`` through a memory map.
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


def _primary() -> bool:
    """Whether this process writes (rank 0, or the only process)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


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
        if not _primary():
            return
        if async_:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_state, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host_state, extra or {})

    def wait(self) -> None:
        """Until the last save is on disk (on several ranks: every rank
        waits for rank 0's writer)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()

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

    def restore(self, like=None, step: Optional[int] = None,
                shardings=None) -> Tuple[Dict[str, Any], Dict]:
        """(the state as a nested dict of numpy arrays, extra) of ``step``
        (default: the latest).  ``like``, a tree of the saved structure
        (values ignored), names the leaves to read: each must be in the
        checkpoint.  Without it every saved leaf is read.

        ``shardings`` (``Rules.shardings``: a tree of ``(mesh,
        placements)`` pairs shaped like the state) makes each leaf of
        rank >= 1 a DTensor on the mesh's device holding this rank's
        shard, read from the file through a memory map; a scalar stays an
        array."""
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

        def read(n):
            path = os.path.join(d, files[n])
            if shardings is None:
                return np.load(path)
            arr = np.load(path, mmap_mode="r")
            if arr.ndim == 0:
                return np.array(arr)
            mesh, pl = _at(shardings, n)
            return _shard(arr, mesh, pl)
        state = _unflatten((n, read(n)) for n in names)
        return state, manifest["extra"]


def _at(tree, name: str):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def _shard(arr: np.ndarray, mesh, placements):
    """This rank's shard of the full array ``arr`` (a memory map: only the
    shard's bytes are read) as a DTensor on the mesh's device."""
    from repro_torch.parallel import spmd
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    loc = torch.from_numpy(np.array(spmd.local_slice(arr, mesh, placements)))
    return spmd.from_local(loc.to(dev), mesh, placements, arr.shape)
