"""Shared model machinery: the IAAT matmul hook, RMSNorm, RoPE
(counterpart of ``repro/models/common.py``).

The ``be`` threaded through the model stack is a
:class:`repro_torch.api.Policy`, so the layers consult the router
directly.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional

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
