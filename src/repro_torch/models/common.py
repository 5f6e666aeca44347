"""Shared model machinery: the IAAT matmul hook, RMSNorm, RoPE
(counterpart of ``repro/models/common.py``).

The ``be`` threaded through the model stack is a
:class:`repro_torch.api.Policy`, so the layers consult the router
directly.
"""
from __future__ import annotations

import contextvars
import copy
import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from repro_torch import api
from repro_torch.api import Policy


def mm(x: torch.Tensor, w: torch.Tensor,
       be: Optional[Policy] = None) -> torch.Tensor:
    """The framework matmul: every projection goes through here, so the
    paper's input-aware dispatch applies uniformly.

    Unlike the reference, ``w`` is NOT cast here: in eager torch that
    would recast the tied 50304x2048 embedding on every decode step, so
    the port casts weights to the compute dtype once, at load
    (``lm.DenseLM``).  The cast is deterministic, so the numbers are the
    same."""
    return api.matmul(x, w, policy=be)


def rmsnorm(x: torch.Tensor, w: Optional[torch.Tensor],
            eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.float()
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, H, S, D); positions: (B, S) or (S,)."""
    D = x.shape[-1]
    half = D // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[:, None, :, None].float() * freq       # (B,1,S,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def map_params(module: nn.Module,
               fn: Callable[[str, torch.Tensor], torch.Tensor],
               requires_grad: bool = False) -> nn.Module:
    """A copy of ``module`` whose every parameter ``p`` (named ``name``, as
    ``named_parameters`` names it) is ``fn(name, p)``, requiring grad or
    not; a parameter the module shares stays one parameter.  The train
    step builds its working copy and the optimizer its moments by it."""
    memo = {id(p): nn.Parameter(fn(name, p), requires_grad=requires_grad)
            for name, p in module.named_parameters()}
    return copy.deepcopy(module, memo)


# --------------------------------------------------------------------------
# Rematerialisation of one layer (the reference's ``lm._remat``).
# --------------------------------------------------------------------------

def _dots_policy(ctx, op, *args, **kwargs):
    """``remat = "dots"``: save the outputs of the matmuls without batch
    dims (``mm``, ``addmm``), as
    ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``;
    ``bmm`` (the attention oracle's and the experts' batched products)
    and everything else is recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if getattr(op, "overloadpacket", None) in (aten.mm, aten.addmm):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(cfg, fn: Callable, *args):
    """``fn(*args)``, one layer's body, checkpointed as ``cfg.remat``
    says, as the reference wraps each scanned body in ``jax.checkpoint``:
    ``"full"`` saves only the body's inputs and recomputes the rest in the
    backward pass; ``"dots"`` also saves the outputs of the matmuls
    without batch dims (selective checkpointing); ``"none"`` saves
    everything.  Where autograd records nothing (``torch.no_grad``) the
    body just runs.  Weights the body closes over (the hybrid's shared
    block) stay one tensor: the recompute reads the same parameters.
    The body runs in a copy of the caller's context, forward and
    recompute alike: on the card the backward pass runs on autograd's own
    thread, which would otherwise see no activation context (the MoE
    layer's shard count) and no scoped policy."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    fn = functools.partial(contextvars.copy_context().run, fn)
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    elif cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r}: full, dots or none")
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


# --------------------------------------------------------------------------
# Logical-axis specs (the reference's tree, read by ``parallel/rules.py``).
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Struct:
    """A leaf's shape and dtype with no storage (``jax.ShapeDtypeStruct``):
    the dry run's stand-in for a parameter, a state or cache tensor."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @classmethod
    def of(cls, t: Optional[torch.Tensor]) -> Optional["Struct"]:
        return None if t is None else cls(tuple(t.shape), t.dtype)

    @classmethod
    def stack(cls, leaves) -> "Struct":
        return cls((len(leaves),) + leaves[0].shape, leaves[0].dtype)

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


#: ``params_to_numpy``'s ``form`` for a tree of :class:`Struct`
STRUCTS = (Struct.of, Struct.stack)


def stack_specs(specs):
    """Prepend the "layers" logical axis to every spec in the tree; None
    (an absent parameter) stays None, as in the reference's tree map."""
    if specs is None:
        return None
    if isinstance(specs, tuple):
        return ("layers",) + specs
    return {k: stack_specs(v) for k, v in specs.items()}
