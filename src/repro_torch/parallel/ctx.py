"""Activation-sharding context: ``constrain(x, *logical_axes)``
(counterpart of ``repro/parallel/ctx.py``).

Model code calls ``constrain(x, "batch", "heads", ...)`` with *logical*
activation axes where the reference does.  Outside an
:func:`activation_sharding` context, and on a plain tensor (one rank),
it is the identity; on a DTensor it redistributes to the placements the
axes resolve to, with the reference's divisibility guard.  The context
also carries ``_moe_shards``, the MoE layer's number of dispatch groups
(:func:`moe_shard_count`).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Optional

from repro_torch.parallel.rules import Axis, axis_size, spec_placements


@dataclasses.dataclass(frozen=True)
class ActCtx:
    mesh: Any
    axes: Dict[str, Axis]


_CTX: contextvars.ContextVar[Optional[ActCtx]] = contextvars.ContextVar(
    "repro_torch_activation_sharding", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, axes: Dict[str, Axis]):
    tok = _CTX.set(ActCtx(mesh, axes))
    try:
        yield
    finally:
        _CTX.reset(tok)


def constrain(x, *logical: Optional[str]):
    """``x`` laid out by its logical axes in the active context: the
    identity outside one, on None, on a rank mismatch and on a plain
    tensor; a DTensor is redistributed (an axis its dim does not divide
    is dropped rather than split unevenly)."""
    ctx = _CTX.get()
    if ctx is None or x is None or x.ndim != len(logical):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    resolved = []
    for dim, a in zip(x.shape, logical):
        ax = ctx.axes.get(a) if isinstance(a, str) else a
        if ax is not None and dim % axis_size(ctx.mesh, ax) != 0:
            ax = None
        resolved.append(ax)
    return x.redistribute(x.device_mesh,
                          spec_placements(ctx.mesh, tuple(resolved)))


def moe_shard_count() -> int:
    """Number of independent MoE dispatch groups (the data-parallel
    degree), 1 outside a context."""
    ctx = _CTX.get()
    if ctx is None:
        return 1
    return int(ctx.axes.get("_moe_shards", 1))


def activation_axes(cfg, mesh, batch_axes: Axis) -> Dict[str, Axis]:
    """Logical activation axes -> mesh axes (divisibility-checked), the
    reference's table."""
    md = axis_size(mesh, "model")

    def ok(n):
        return "model" if n and n % md == 0 else None

    axes: Dict[str, Axis] = {
        "batch": batch_axes,
        "heads": ok(cfg.n_heads_padded),
        "kv": ok(cfg.n_kv_heads_padded),
        "mlp": ok(cfg.d_ff),
        "vocab": ok(cfg.vocab_padded),
        "seq": None,
    }
    if cfg.moe:
        # one dispatch group per batch shard; the group axis carries the
        # batch sharding
        ba = batch_axes if batch_axes else None
        axes["moe_group"] = ba
        axes["_moe_shards"] = axis_size(mesh, ba)
        if cfg.moe.num_experts % md == 0:
            axes["experts"] = "model"
            axes["expert_mlp"] = None
        else:
            axes["experts"] = None
            axes["expert_mlp"] = ok(cfg.moe.d_expert)
    if cfg.ssm:
        axes["inner"] = ok(cfg.d_inner)
        axes["ssm_heads"] = ok(cfg.ssm_heads)
    return axes
