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
in-process store, so no network port is opened; :func:`release_mesh`
takes down a group it brought up.  :func:`mesh_shape` is the shape-only
stand-in (``parallel.rules.MeshShape``) the dry run reads.
"""
from __future__ import annotations

import math
from typing import Sequence

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
    """Take down the one-rank group :func:`make_host_mesh` brought up (a
    group the caller brought up is left alone)."""
    import torch.distributed as dist
    if _OWNED and dist.is_initialized():
        dist.destroy_process_group()
    _OWNED.clear()

