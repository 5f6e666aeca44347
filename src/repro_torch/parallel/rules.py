"""Logical-axis -> mesh-axis sharding rules (DP / FSDP / TP / EP / SP)
(counterpart of ``repro/parallel/rules.py``).

Model code names the *logical* axes of every parameter ("embed",
"heads", "mlp", "vocab", "experts", ...: ``registry.Model.specs``).
This module maps them onto a mesh with the reference's table and its
divisibility-aware fallbacks:

  TP    heads/kv_heads/mlp/expert_mlp/vocab/inner -> "model"
  EP    experts -> "model" when num_experts divides the axis (else the
        expert MLP dim takes the TP shard instead)
  FSDP  embed -> "data" (params and optimizer state sharded over data)
  DP    batch -> ("pod", "data"): the pod axis is pure DP
  SP    cache_seq -> "data" for the batch-1 long-context decode cells

Indivisible cases (smollm's 15 heads, gemma3's 4 heads on a 16-way model
axis) fall back to replication, recorded by :meth:`Rules.report`.

A spec here is the reference's ``PartitionSpec`` as a tuple: one entry
per tensor dim, each a mesh axis name, a tuple of names (one tensor dim
split over several mesh axes, major to minor) or None.
:func:`spec_placements` turns it into DTensor placements, one
``Shard(dim)`` or ``Replicate()`` per mesh dim.  The rules read only the
mesh's axis names and sizes (:func:`axis_sizes`), so a real
``DeviceMesh`` and the shape-only :class:`MeshShape` serve alike: the
dry run and the tests need no process group of 256.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.common import Struct

Axis = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes and nothing else (the reference's
    ``AbstractMesh``): what the rules read from a ``DeviceMesh``."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size(self) -> int:
        return math.prod(self.shape)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshShape`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axis_size(mesh, ax: Axis) -> int:
    """How many ways ``ax`` (a name, a tuple of names or None) splits a
    dim; an axis the mesh lacks counts 1, as in the reference."""
    sizes = axis_sizes(mesh)
    if ax is None:
        return 1
    if isinstance(ax, str):
        return sizes.get(ax, 1)
    return math.prod(sizes.get(a, 1) for a in ax)


def _names(ax: Axis) -> Tuple[str, ...]:
    return () if ax is None else (ax,) if isinstance(ax, str) else tuple(ax)


def spec_placements(mesh, spec: Tuple[Axis, ...]):
    """A spec as DTensor placements over ``mesh``: mesh dim ``j`` is
    ``Shard(d)`` where tensor dim ``d`` names it, else ``Replicate()``.
    A tuple on one dim must list its mesh axes in the mesh's order (major
    to minor), which is what DTensor's repeated ``Shard(d)`` means."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(mesh.mesh_dim_names)
    where: Dict[str, int] = {}
    for d, ax in enumerate(spec):
        names = [a for a in _names(ax) if a in order]
        if [order.index(a) for a in names] != sorted(
                order.index(a) for a in names):
            raise ValueError(f"spec {spec}: {ax} is not in the mesh's "
                             f"axis order {tuple(order)}")
        for a in names:
            if a in where:
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in order)


def spec_local_shape(mesh, spec: Tuple[Axis, ...],
                     shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """One device's shard of a ``shape`` tensor laid out by ``spec``
    (dims past the spec are whole); an uneven split raises, as the
    reference's ``NamedSharding.shard_shape`` does."""
    out = []
    for d, n in enumerate(shape):
        k = axis_size(mesh, spec[d]) if d < len(spec) else 1
        if n % k:
            raise ValueError(f"dim {d} of {tuple(shape)} ({n}) does not "
                             f"split {k} ways (spec {spec})")
        out.append(n // k)
    return tuple(out)


@dataclasses.dataclass
class Rules:
    mesh: Any
    table: Dict[str, Axis]
    fallbacks: Dict[str, str]

    def spec(self, logical: Optional[Tuple]) -> Tuple[Axis, ...]:
        """The reference's ``PartitionSpec`` of a parameter whose logical
        axes are ``logical`` (None or (): replicated)."""
        if logical is None:
            return ()
        return tuple(self.table.get(ax) if isinstance(ax, str) else ax
                     for ax in logical)

    def placements(self, logical: Optional[Tuple]):
        return spec_placements(self.mesh, self.spec(logical))

    def local_shape(self, logical: Optional[Tuple],
                    global_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return spec_local_shape(self.mesh, self.spec(logical), global_shape)

    def tree_local(self, spec_tree, struct_tree):
        """One device's :class:`Struct` for every leaf of ``struct_tree``
        (a tree of global Structs shaped like ``spec_tree``: tuples,
        () included, are leaves; None, an absent parameter, stays
        None)."""
        if spec_tree is None:
            return None
        if isinstance(spec_tree, tuple):
            return Struct(self.local_shape(spec_tree, struct_tree.shape),
                          struct_tree.dtype)
        return {k: self.tree_local(v, struct_tree[k])
                for k, v in spec_tree.items()}

    def distribute(self, tree, spec_tree):
        """``tree`` with every tensor leaf a DTensor over the rules' mesh
        (a ``DeviceMesh``), laid out by its spec in ``spec_tree`` (the
        reference's ``tree_shardings`` and ``jit(out_shardings=)``).  A
        leaf is a tensor, or an ``nn.Module`` whose parameters are
        matched to the spec tree by :func:`param_spec`; anything else (a
        step count, None) is kept.  Every rank holds the same full
        leaves and keeps its slice (``spmd.distribute``)."""
        from torch import nn

        from repro_torch.models.common import map_params
        from repro_torch.parallel import spmd
        if isinstance(tree, dict):
            return {k: self.distribute(v, spec_tree[k])
                    for k, v in tree.items()}
        if isinstance(tree, nn.Module):
            return map_params(tree, lambda name, p: spmd.distribute(
                p, self.mesh, self.placements(param_spec(spec_tree,
                                                         name))))
        if spmd.is_dtensor(tree) or not hasattr(tree, "shape"):
            return tree
        return spmd.distribute(tree, self.mesh, self.placements(spec_tree))

    def shardings(self, spec_tree):
        """``spec_tree`` with every spec a ``(mesh, placements)`` pair (the
        reference's ``tree_shardings``), as ``Checkpointer.restore``
        reads it; None stays None."""
        if spec_tree is None:
            return None
        if isinstance(spec_tree, tuple):
            return (self.mesh, self.placements(spec_tree))
        return {k: self.shardings(v) for k, v in spec_tree.items()}

    def report(self) -> str:
        lines = [f"{k} -> {v}" for k, v in sorted(self.table.items())]
        lines += [f"FALLBACK {k}: {v}"
                  for k, v in sorted(self.fallbacks.items())]
        return "\n".join(lines)


def param_spec(spec_tree, name: str):
    """The spec of the module parameter ``name`` (as ``named_parameters``
    names it) in ``spec_tree`` (``params_to_numpy``'s tree): the path
    without its layer indices, and a leaf of a layer stack without its
    leading "layers" axis (the port keeps one module per layer)."""
    node, stacked = spec_tree, False
    for part in name.split("."):
        if part.isdigit():
            stacked = True
            continue
        node = node[part]
    if stacked and node and node[0] == "layers":
        node = node[1:]
    return node


def make_rules(cfg: ModelConfig, mesh, *, fsdp: bool = True,
               shard_experts: bool = True) -> Rules:
    """The reference's table and fallbacks for ``cfg`` on ``mesh``."""
    md = axis_size(mesh, "model")
    dd = axis_size(mesh, "data")
    t: Dict[str, Axis] = {"layers": None}
    fb: Dict[str, str] = {}

    def give(name: str, size: int, axis: str, reason_ok=True):
        ax = axis_size(mesh, axis)
        if size and size % ax == 0 and reason_ok:
            t[name] = axis
        else:
            t[name] = None
            fb[name] = f"size {size} % {axis}({ax}) != 0 -> replicate"

    H, Hkv, hd = cfg.n_heads_padded, cfg.n_kv_heads_padded, \
        (cfg.head_dim_ if cfg.n_heads else 0)
    give("heads", H * hd if H else 0, "model",
         reason_ok=H % md == 0 if H else False)
    give("kv_heads", Hkv * hd if Hkv else 0, "model",
         reason_ok=Hkv % md == 0 if Hkv else False)
    give("mlp", cfg.d_ff, "model")
    give("vocab", cfg.vocab_padded, "model")
    if cfg.ssm:
        give("inner", cfg.d_inner, "model")
        t["ssm_heads"] = None
    if cfg.moe:
        E, fe = cfg.moe.num_experts, cfg.moe.d_expert
        if shard_experts and E % md == 0:
            t["experts"] = "model"          # EP
            t["expert_mlp"] = None
        else:
            t["experts"] = None
            give("expert_mlp", fe, "model")
            if E % md:
                fb["experts"] = (f"{E} experts % model({md}) != 0 -> TP on "
                                 "expert_mlp")
    if fsdp and cfg.d_model % dd == 0:
        t["embed"] = "data"
    else:
        t["embed"] = None
        if fsdp:
            fb["embed"] = f"d_model {cfg.d_model} % data({dd}) != 0"
    return Rules(mesh, t, fb)


# --------------------------------------------------------------------------
# Input / cache layouts per shape cell.
# --------------------------------------------------------------------------

def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that act as pure data parallelism (pod is DP only)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def batch_spec(mesh, global_batch: int) -> Optional[Tuple[str, ...]]:
    """The batch dim's mesh axes: (pod, data) where the batch splits over
    both, else data alone where it splits over data, else None."""
    axes = batch_axes(mesh)
    n = axis_size(mesh, axes)
    if axes and global_batch % n == 0:
        return axes
    if global_batch % axis_size(mesh, "data") == 0:
        return ("data",)
    return None


def data_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
               rules: Rules) -> Dict[str, Tuple[Axis, ...]]:
    """Specs of the batch inputs (tokens, labels, embeddings)."""
    b = batch_spec(mesh, shape.global_batch)
    tok, emb = (b, None), (b, None, None)
    return {"tokens": tok, "labels": tok, "prefix_embeds": emb,
            "src_embeds": emb}


def data_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   rules: Rules) -> Dict[str, Tuple]:
    """DTensor placements of the batch inputs (the reference's
    NamedShardings)."""
    return {k: spec_placements(mesh, s)
            for k, s in data_specs(cfg, shape, mesh, rules).items()}


def cache_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    rules: Rules) -> Dict[str, Tuple[Axis, ...]]:
    """Specs of the KV / SSM cache tensors (leading L or n_apps dim).

    batch >= data axis -> shard batch; batch == 1 (long context) -> shard
    the cache *sequence* dim over data (SP for decode); kv heads
    replicated (indivisible) -> shard the cache sequence over model.
    ``pos`` is the reference's device scalar; the port keeps it on the
    host."""
    b = batch_spec(mesh, shape.global_batch)
    kvh = rules.table.get("kv_heads")
    seq = None
    if b is None:
        seq = "data"
    elif kvh is None:
        seq = "model"
    attn = (None, b, kvh, seq, None)
    return {
        "attn_k": attn, "attn_v": attn,
        "shared_k": attn, "shared_v": attn,
        "conv": (None, b, None, rules.table.get("inner")),
        "ssm": (None, b, rules.table.get("ssm_heads"), None, None),
        "self_k": attn, "self_v": attn,
        "cross_k": attn, "cross_v": attn,
        "pos": (),
    }


def cache_placements(cfg: ModelConfig, mesh, batch: int) -> Dict[str, Tuple]:
    """DTensor placements of the cache tensors of ``batch`` sequences on
    ``mesh`` (a ``DeviceMesh``): :func:`cache_shardings`'s specs, which
    read only the batch of the shape and the rules' table."""
    shape = ShapeConfig("cache", 0, batch, "decode")
    return {k: spec_placements(mesh, s) for k, s in cache_shardings(
        cfg, shape, mesh, make_rules(cfg, mesh)).items()}
