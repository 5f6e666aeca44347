"""Running on several ranks: the DTensor side of the sharding rules.

The rules (``parallel/rules.py``) give every leaf a spec; here a spec
becomes a DTensor over a ``DeviceMesh`` and the model's regions run on
each rank's local shards:

* :func:`distribute` places a full tensor by its placements, each rank
  keeping a copy of its own slice only (no collective: every rank holds
  the same full tensor, drawn from the same seed or read from the same
  checkpoint); :func:`local_offset` is the slice's corner.
* :func:`gather_fsdp` is the FSDP weight all-gather: a weight's
  placements on the batch axes (``pod``, ``data``) become ``Replicate``,
  its tensor-parallel placements on ``model`` stay.  DTensor's own matmul
  strategy would all-gather the activation instead (an activation
  ``[Shard(0), Replicate()]`` against a weight ``[Shard(0), Shard(1)]``
  leaves the output ``Partial`` on ``data``), so the port never hands it
  a sharded weight.
* :func:`sharded_matmul` is ``api.matmul`` on DTensors: the weight
  gathered, the activation laid out for the weight's ``model`` placement,
  and the routed GEMM run through ``local_map`` on the local tensors, so
  the router and the IAAT kernel see each rank's (M, N, K):
  column-parallel ``w [.., Shard(1)]`` gives an output ``Shard(-1)``,
  row-parallel ``w [.., Shard(0)]`` against ``x [.., Shard(-1)]`` gives
  ``Partial``, a replicated weight gives the output ``x``'s placements.
* :func:`local` runs a region with no sharding strategy of its own (the
  attention oracle, RoPE, the MoE dispatch, the mamba mixer, the loss)
  on the local tensors, every output laid out as the caller says.

On one rank (plain tensors) only :func:`any_dtensor`'s check runs, once
a routed GEMM.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor

#: mesh axes that only split the batch (the FSDP axis and pure DP)
BATCH_AXES = ("pod", "data")


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def any_dtensor(*xs) -> bool:
    """Whether any of ``xs`` is a DTensor (asked on every routed GEMM:
    two ``isinstance`` checks, no import)."""
    return isinstance(xs[0], DTensor) or any(isinstance(x, DTensor)
                                             for x in xs[1:])


def replicate(mesh):
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in range(mesh.ndim))


def local_offset(shape: Sequence[int], mesh, placements) -> Tuple[int, ...]:
    """The corner of this rank's slice of a ``shape`` tensor laid out by
    ``placements`` (even splits; a dim split over several mesh dims is
    split major to minor, as DTensor's repeated ``Shard(d)``)."""
    coord = mesh.get_coordinate()
    off = [0] * len(shape)
    size = list(shape)
    for j, p in enumerate(placements):
        if p.is_shard():
            d = p.dim % len(shape)
            n = mesh.size(j)
            if size[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"{n} ways")
            size[d] //= n
            off[d] += coord[j] * size[d]
    return tuple(off)


def local_shape(shape: Sequence[int], mesh, placements) -> Tuple[int, ...]:
    out = list(shape)
    for j, p in enumerate(placements):
        if p.is_shard():
            out[p.dim % len(shape)] //= mesh.size(j)
    return tuple(out)


def local_slice(full, mesh, placements):
    """This rank's slice of ``full`` (a tensor or an array), a view."""
    off = local_offset(full.shape, mesh, placements)
    shp = local_shape(full.shape, mesh, placements)
    return full[tuple(slice(o, o + n) for o, n in zip(off, shp))]


def from_local(local: torch.Tensor, mesh, placements, global_shape):
    """A DTensor of ``global_shape`` whose shard on this rank is
    ``local`` (contiguous global strides, no check, no collective)."""
    shape = tuple(global_shape)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def distribute(full: torch.Tensor, mesh, placements):
    """``full`` (the same on every rank) as a DTensor: each rank keeps a
    copy of its own slice, so the full tensor can be freed."""
    loc = local_slice(full.detach(), mesh, placements).clone(
        memory_format=torch.contiguous_format)
    return from_local(loc, mesh, placements, full.shape)


def gather_fsdp(w):
    """The FSDP weight all-gather: ``w`` replicated over the batch axes,
    its ``model`` placements kept (a no-op where nothing is sharded
    there); differentiable (its backward is the reduce-scatter)."""
    from torch.distributed.tensor import Replicate
    mesh = w.device_mesh
    names = mesh.mesh_dim_names or ()
    pl = tuple(Replicate() if n in BATCH_AXES else p
               for n, p in zip(names, w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(mesh, pl)


def as_dtensor(t, mesh):
    """A plain tensor as a DTensor replicated over ``mesh``."""
    return t if is_dtensor(t) else from_local(t, mesh, replicate(mesh),
                                              t.shape)


def settle(x):
    """``x`` with every ``Partial`` placement reduced (to ``Replicate``):
    what a region that is not linear in ``x`` must read.  A plain tensor
    or None passes."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def whole(w):
    """``w`` replicated over the whole mesh (None and a plain tensor
    pass): a small weight a local region reads in full."""
    if not is_dtensor(w):
        return w
    rep = replicate(w.device_mesh)
    return w if tuple(w.placements) == rep else \
        w.redistribute(w.device_mesh, rep)


def local(fn: Callable, out_placements, *args, mesh=None):
    """``fn`` on the local tensors of ``args`` (DTensors as they are laid
    out; plain tensors and other values are passed as they are, so they
    must be the same on every rank), each output a DTensor with the
    matching entry of ``out_placements`` (a placements tuple, or a
    tuple of them for several outputs).  A ``Partial`` input raises:
    :func:`settle` it first.

    Differentiable.  A mesh dim that shards any input splits the
    region's work, so the gradient of an input replicated over that dim
    is the sum of every rank's share: it leaves the region ``Partial``
    there (a column-parallel GEMM's activation, a weight against
    batch-sharded rows), and DTensor reduces it where the input came
    from (the all-reduce, or the FSDP gather's reduce-scatter)."""
    from torch.distributed.tensor import Partial, Placement
    from torch.distributed.tensor.experimental import local_map
    mesh = mesh or next(a.device_mesh for a in args if is_dtensor(a))
    in_pl = tuple(tuple(a.placements) if is_dtensor(a) else None
                  for a in args)
    if any(p.is_partial() for pl in in_pl if pl for p in pl):
        raise ValueError(f"local region on a Partial input: {in_pl}")
    split = [any(pl[j].is_shard() for pl in in_pl if pl)
             for j in range(mesh.ndim)]
    grad_pl = tuple(None if pl is None else tuple(
        Partial() if split[j] and p.is_replicate() else p
        for j, p in enumerate(pl)) for pl in in_pl)
    # local_map reads a list as one output's placements, a tuple as one
    # entry an output
    if all(isinstance(p, Placement) for p in out_placements):
        out_pl = list(out_placements)
    else:
        out_pl = tuple(list(p) for p in out_placements)
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh)(*args)


def sharded_matmul(x, w, local_fn: Callable):
    """(..., K) @ (K, N) on DTensors, ``local_fn(x_local, w_local)`` the
    routed GEMM on each rank's shards (see the module's docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = (w if is_dtensor(w) else x).device_mesh
    w = gather_fsdp(as_dtensor(w, mesh))
    x = as_dtensor(x, mesh)
    last = x.ndim - 1
    xp, out = [], []
    for a, b in zip(x.placements, w.placements):
        if b.is_shard(1):                    # column-parallel: N split
            xp.append(Replicate())
            out.append(Shard(last))
        elif b.is_shard(0):                  # row-parallel: K split
            xp.append(Shard(last))
            out.append(Partial())
        elif a.is_shard(last):               # K split against a whole w
            xp.append(Replicate())
            out.append(Replicate())
        else:
            xp.append(a)
            out.append(a)
    if tuple(xp) != tuple(x.placements):
        x = x.redistribute(mesh, tuple(xp))
    return local(local_fn, tuple(out), x, w, mesh=mesh)


def zeros(shape: Sequence[int], dtype, device, mesh, placements):
    """A zero DTensor of ``shape`` laid out by ``placements``: each rank
    allocates its own shard only (no collective)."""
    loc = torch.zeros(local_shape(shape, mesh, placements), dtype=dtype,
                      device=device)
    return from_local(loc, mesh, placements, shape)


def write(dst, index: Tuple, src) -> None:
    """``dst[index] = src`` in place, ``index`` a tuple of ints and unit-step
    slices over ``dst``'s leading dims.  On a DTensor ``dst`` each rank
    writes its own shard only: ``src`` (a DTensor, or a plain tensor the
    same on every rank) is laid out as ``dst`` on the dims written whole,
    replicated on a sliced dim that ``dst`` shards, where each rank keeps
    the part of the slice it holds (a ring slot on the rank that owns it,
    nothing on the others).  An int indexes a dim that is whole on every
    rank.  The redistribution of ``src`` is the only collective."""
    if not is_dtensor(dst):
        dst[index] = src
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = dst.device_mesh
    shape = tuple(dst.shape)
    lo = local_offset(shape, mesh, dst.placements)
    ln = local_shape(shape, mesh, dst.placements)
    ints = [d for d, i in enumerate(index) if isinstance(i, int)]
    spans = {d: i.indices(shape[d]) for d, i in enumerate(index)
             if isinstance(i, slice)}
    if any(s[2] != 1 for s in spans.values()):
        raise ValueError(f"write: slices of step 1 only, got {index}")
    sliced = {d for d, (a, b, _) in spans.items()
              if (a, b) != (0, shape[d])}
    pl = []
    for p in dst.placements:
        if p.is_shard() and p.dim in ints:
            raise ValueError(f"write: dim {p.dim} is sharded and indexed by "
                             "an int")
        if p.is_shard() and p.dim not in sliced:
            pl.append(Shard(p.dim - sum(1 for d in ints if d < p.dim)))
        else:
            pl.append(Replicate())
    src = settle(as_dtensor(src, mesh))
    if tuple(src.placements) != tuple(pl):
        src = src.redistribute(mesh, tuple(pl))
    didx, sidx = [], []
    for d in range(len(shape)):
        i = index[d] if d < len(index) else slice(None)
        if isinstance(i, int):
            didx.append(i)
            continue
        a, b, _ = spans.get(d, (0, shape[d], 1))
        if d in sliced and ln[d] != shape[d]:
            s, e = max(a, lo[d]), min(b, lo[d] + ln[d])
            if s >= e:
                return                   # no slot of the slice lives here
            didx.append(slice(s - lo[d], e - lo[d]))
            sidx.append(slice(s - a, e - a))
        else:
            didx.append(slice(a, b) if d in sliced else slice(None))
            sidx.append(slice(None))
    dst.to_local()[tuple(didx)].copy_(src.to_local()[tuple(sidx)])


def owned_sum(tensors) -> torch.Tensor:
    """sum of ``t.float() ** 2`` over DTensors ``tensors``, each element
    counted once across the world: each rank adds its local squares only
    for the leaves whose replicas it owns (coordinate 0 on every mesh dim
    a leaf is replicated over), then one all-reduce.  A plain f32 scalar
    on the local device, the same on every rank."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    total = None
    for t in tensors:
        coord = t.device_mesh.get_coordinate()
        if any(not p.is_shard() and c for p, c in zip(t.placements, coord)):
            continue
        s = torch.sum(torch.square(t.to_local().float()))
        total = s if total is None else total + s
    if total is None:
        dev = next(iter(tensors)).to_local().device
        total = torch.zeros((), dtype=torch.float32, device=dev)
    if dist.get_world_size() > 1:
        total = funcol.wait_tensor(
            funcol.all_reduce(total, "sum", dist.group.WORLD))
    return total


def shard_coordinate(mesh, placements, dim: int = 0) -> Tuple[int, int]:
    """(this rank's index among the shards of ``dim``, their number) for a
    tensor laid out by ``placements``: the coordinate over the mesh dims
    that split ``dim``, major to minor.  For a batch, the reference's
    process index and count, by which each rank reads its own rows."""
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for j, p in enumerate(placements):
        if p.is_shard(dim):
            idx = idx * mesh.size(j) + coord[j]
            n *= mesh.size(j)
    return idx, n
