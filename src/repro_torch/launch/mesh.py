"""Device meshes (counterpart of ``repro/launch/mesh.py``).

Functions over ``torch.distributed.device_mesh.init_device_mesh``;
nothing happens at import.  The shapes are the reference's: 16 x 16
``("data", "model")`` for one pod, 2 x 16 x 16 ``("pod", "data",
"model")`` for two, so the sharding rules' tables stay comparable with
the reference's.  A ``DeviceMesh`` needs a process group of its size:
:func:`make_mesh` raises, naming the world it needs, where the group is
smaller, as ``jax.make_mesh`` raises on a host without the devices.
:func:`make_host_mesh` is the 1 x 1 mesh of one rank, which brings up a
one-rank group if none exists (NCCL on the card, gloo on the CPU) over an
in-process store, so no network port is opened.  A world of several
ranks comes up from the ``torchrun`` environment (:func:`init_world`:
NCCL with each rank on ``cuda:LOCAL_RANK``, gloo on the CPU), or, for
tests, from :func:`spawn` (N processes over a ``FileStore`` in a
temporary directory: no TCP port to clash between test workers).
:func:`release_mesh` takes down a group this module brought up.
:func:`mesh_shape` is the shape-only stand-in
(``parallel.rules.MeshShape``) the dry run reads.
"""
from __future__ import annotations

import math
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch

from repro_torch.parallel.rules import MeshShape, batch_axes  # noqa: F401

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}

_OWNED = []          # the one-rank group make_host_mesh brought up


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_shape(shape: Sequence[int], axes: Sequence[str]) -> MeshShape:
    """A mesh's axis names and sizes, no devices and no process group."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh {tuple(shape)} with axes {tuple(axes)}")
    return MeshShape(tuple(int(n) for n in shape), tuple(axes))


def production_shape(multi_pod: bool = False) -> MeshShape:
    """The production mesh's shape (see :func:`make_production_mesh`)."""
    return mesh_shape(*PRODUCTION[multi_pod])


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the process
    group, which must hold exactly prod(shape) ranks."""
    need, world = math.prod(shape), _world()
    if world != need:
        raise ValueError(
            f"a {' x '.join(map(str, shape))} mesh {tuple(axes)} needs a "
            f"world of {need} ranks; this one has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes, device_type)


def make_host_mesh(device: str = "cuda"):
    """The degenerate 1 x 1 ``("data", "model")`` mesh of this one rank.

    Brings up a one-rank process group when none exists: NCCL for a CUDA
    ``device`` (initialised now, so a failure shows here), gloo for the
    CPU, both over an in-process ``HashStore``.  An existing group must
    be one rank."""
    import torch.distributed as dist
    dev = torch.device(device)
    if not dist.is_initialized():
        kw = {}
        if dev.type == "cuda":
            kw["device_id"] = torch.device(
                "cuda", dev.index if dev.index is not None
                else torch.cuda.current_device())
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1, **kw)
        _OWNED.append(True)
    return make_mesh((1, 1), ("data", "model"), dev.type)


def release_mesh() -> None:
    """Take down the group :func:`make_host_mesh`, :func:`init_world` or
    :func:`spawn` brought up (a group the caller brought up is left
    alone)."""
    import torch.distributed as dist
    if _OWNED and dist.is_initialized():
        dist.destroy_process_group()
    _OWNED.clear()



def init_world(device_type: str = "cuda") -> torch.device:
    """Bring up the process group of a ``torchrun`` world (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``):
    NCCL on the card, each rank on ``cuda:LOCAL_RANK`` (initialised now,
    so a failure shows here), gloo on the CPU.  Returns the rank's
    device; :func:`release_mesh` takes the group down."""
    import torch.distributed as dist
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device_type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", rank=rank, world_size=world,
                                device_id=dev)
    else:
        dev = torch.device("cpu")
        dist.init_process_group("gloo", rank=rank, world_size=world)
    _OWNED.append(True)
    return dev


def _spawned(rank: int, world: int, root: str, backend: str, fn, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = {"rank": rank}
    try:
        store = dist.FileStore(os.path.join(root, "store"), world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        _OWNED.append(True)
        out["result"] = fn(rank, world, *args)
    except BaseException:            # noqa: BLE001 — reported by spawn
        out["error"] = traceback.format_exc()
    finally:
        release_mesh()
    with open(os.path.join(root, f"rank{rank}.pkl.tmp"), "wb") as f:
        pickle.dump(out, f)
    os.replace(os.path.join(root, f"rank{rank}.pkl.tmp"),
               os.path.join(root, f"rank{rank}.pkl"))


def spawn(fn: Callable, world: int, *args: Any, timeout: float = 240.0,
          backend: str = "gloo") -> List[Any]:
    """``fn(rank, world, *args)`` in ``world`` new processes, one a rank,
    over a process group brought up on a ``FileStore`` in a temporary
    directory (each rank on one thread); returns the ranks' results in
    rank order.  ``fn`` and ``args`` must pickle (``fn`` a module-level
    function).  A rank that raises, dies or outlives ``timeout`` seconds
    (all ranks together) raises here, after every process is stopped."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as root:
        procs = [ctx.Process(target=_spawned,
                             args=(r, world, root, backend, fn, args),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        end = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, end - time.monotonic()))
            late = [r for r, p in enumerate(procs) if p.is_alive()]
            if late:
                raise TimeoutError(f"ranks {late} of {world} still running "
                                   f"after {timeout:.0f} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        outs = []
        for r, p in enumerate(procs):
            path = os.path.join(root, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} exited with {p.exitcode} and "
                                   "no result")
            with open(path, "rb") as f:
                outs.append(pickle.load(f))
    errs = [o for o in outs if "error" in o]
    if errs:
        raise RuntimeError(f"rank {errs[0]['rank']} of {world} failed:\n"
                           + errs[0]["error"])
    return [o["result"] for o in outs]
