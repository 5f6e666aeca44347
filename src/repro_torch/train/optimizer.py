"""AdamW with a warmup-cosine schedule and global-norm clipping
(counterpart of ``repro/train/optimizer.py``).

It works over a module's named parameters in f32 with plain tensor ops,
updating the master copy and the moments in place.  The reference's
AdamW is no Pallas kernel, so it has no CUDA kernel here either.  The
schedule and the bias corrections are taken in f32, as the reference's
traced arithmetic takes them.  Weight decay applies to the leaves of rank
>= 2; the port keeps one module per layer, so that is the per-layer rank
(the reference tests the rank of its layer-stacked leaves, which decays
the per-layer vectors too: ROADMAP §3).

Memory: f32 master, m and v take 12 bytes a parameter.  On several
ranks they are DTensors laid out alike (FSDP: ``Shard`` on ``embed``),
and the update runs on each rank's shards.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import obs
from repro_torch.models.common import map_params
from repro_torch.parallel import spmd


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 200
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _f32(x) -> np.float32:
    return np.float32(x)


def schedule(step: int, c: OptConfig) -> float:
    """Linear warmup to ``peak_lr``, then cosine down to ``min_lr_ratio``
    of it at ``decay_steps``; the smaller of the two, in f32."""
    s = _f32(step)
    warm = _f32(c.peak_lr) * (s + _f32(1)) / _f32(max(c.warmup_steps, 1))
    t = np.clip((s - _f32(c.warmup_steps))
                / _f32(max(c.decay_steps - c.warmup_steps, 1)),
                _f32(0), _f32(1))
    cos = _f32(c.min_lr_ratio) + _f32(1 - c.min_lr_ratio) * _f32(0.5) \
        * (_f32(1) + np.cos(_f32(np.pi) * t))
    return float(np.minimum(warm, _f32(c.peak_lr) * cos))


def init_opt_state(params: nn.Module) -> Dict[str, nn.Module]:
    """Zero first and second moments shaped as ``params``."""
    def zeros(_name, p):
        return torch.zeros_like(p, dtype=torch.float32)
    return {"m": map_params(params, zeros), "v": map_params(params, zeros)}


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32 (a device
    scalar: no host sync).  DTensor gradients are summed on their shards
    and reduced by one all-reduce (``spmd.owned_sum``): a plain scalar,
    the same on every rank."""
    gs = list(grads.values())
    if gs and spmd.is_dtensor(gs[0]):
        return torch.sqrt(spmd.owned_sum(gs))
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in gs))


@torch.no_grad()
def adamw_update(params: nn.Module, grads: Dict[str, torch.Tensor],
                 opt_state: Dict[str, nn.Module], step: int, c: OptConfig
                 ) -> Tuple[nn.Module, Dict[str, nn.Module],
                            Dict[str, object]]:
    """One AdamW step on ``params`` (f32 master) with ``grads`` (by
    parameter name, any float dtype), in place.  Returns (params,
    opt_state, {"grad_norm": the norm before clipping (a device scalar),
    "lr"}).  Inside an ``obs.capture`` it is the span ``train.optimizer``,
    with its device time."""
    with obs.span("train.optimizer", device=True):
        gnorm = global_norm(grads)
        scale = torch.clamp(c.clip_norm / (gnorm + 1e-9), max=1.0)
        lr = schedule(step, c)
        b1c = float(_f32(1) - _f32(c.b1) ** _f32(step + 1))
        b2c = float(_f32(1) - _f32(c.b2) ** _f32(step + 1))
        m_of = dict(opt_state["m"].named_parameters())
        v_of = dict(opt_state["v"].named_parameters())
        for name, p in params.named_parameters():
            g = grads[name]
            if spmd.is_dtensor(p):       # the update is elementwise
                p, g = p.to_local(), g.to_local()
                m, v = m_of[name].to_local(), v_of[name].to_local()
            else:
                m, v = m_of[name], v_of[name]
            g = g.float() * scale
            m.copy_(c.b1 * m + (1 - c.b1) * g)
            v.copy_(c.b2 * v + (1 - c.b2) * g * g)
            upd = (m / b1c) / (torch.sqrt(v / b2c) + c.eps)
            if p.ndim >= 2:              # no decay on norms, scalars
                upd = upd + c.weight_decay * p.float()
            p.copy_(p.float() - lr * upd)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
