"""The train step: mixed precision, microbatched gradient accumulation,
family-aware loss, AdamW (counterpart of ``repro/train/loop.py``).

A train state is ``{"params": the f32 master module, "opt": {"m", "v"}
(modules of the same structure, f32), "step": a host int}``.  Each step
casts the master to a working copy (:func:`cast_params_for_compute`)
whose leaves require grad, takes the gradients on it through the model's
``forward_train`` (every routed GEMM that ``api.route`` sends to the IAAT
kernel runs it forward inside autograd, its backward being the two
adjoint GEMMs, ``kernels/iaat_gemm._RegionGemm``), and hands them, widened
to f32, to AdamW, which updates the master and the moments in place.
The non-GEMM kernels (flash, grouped, SSD) have no backward, so the
trainer runs under a policy whose ``kernels`` is ``library``, as the
reference's does (``Policy.kernels``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import numpy as np
import torch
from torch import nn

from repro_torch import obs
from repro_torch.api import Policy
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm
from repro_torch.models.common import map_params
from repro_torch.models.registry import Model
from repro_torch.train import optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt.OptConfig = opt.OptConfig()
    accum_steps: int = 1               # microbatch gradient accumulation
    z_loss: float = 1e-4


def init_train_state(model: Model, generator: torch.Generator,
                     device="cuda") -> Dict[str, Any]:
    """Random f32 master weights from ``generator`` on ``device``, zero
    moments, step 0."""
    params = model.init(generator, device, torch.float32)
    return {"params": params, "opt": opt.init_opt_state(params), "step": 0}


def train_state_specs(model: Model) -> Dict[str, Any]:
    """The logical axes of a train state, in :func:`state_to_numpy`'s tree
    (the reference's ``train_state_specs``): the parameters' specs for
    the master and both moments, () for the step."""
    ps = model.specs()
    return {"params": ps, "opt": {"m": ps, "v": ps}, "step": ()}


def _xent(logits, labels, vocab: int, z_loss: float):
    """Masked cross-entropy in f32 + z-loss; labels == -1 are ignored.  The
    logsumexp runs over the padded vocabulary, as the reference's."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp(0, vocab - 1)[..., None])[..., 0]
    valid = (labels >= 0) & (labels < vocab)
    per_tok = (lse - ll) + z_loss * lse ** 2
    per_tok = torch.where(valid, per_tok, torch.zeros((), device=lf.device))
    n = torch.clamp(valid.sum(), min=1)
    return per_tok.sum() / n, n


def record_step(step: int, metrics: Dict[str, float],
                dt_s: float) -> None:
    """Fold one executed train step into the obs registry (called by the
    launcher once the host holds the step's metrics)."""
    obs.counter("train.steps").inc()
    obs.histogram("train.step_us").record(dt_s * 1e6)
    obs.gauge("train.step").set(step)
    if "loss" in metrics:
        obs.gauge("train.loss").set(float(metrics["loss"]))


def make_loss_fn(model: Model, tc: TrainConfig, be: Policy) -> Callable:
    """``loss_fn(params, batch) -> (loss, {"ce", "aux", "tokens"})``.  The
    batch holds ``tokens``, optionally ``labels`` (else the next token,
    -1 at the end), the VLM's ``prefix_embeds`` (whose positions are
    sliced off the logits) and the enc-dec's ``src_embeds``."""
    cfg = model.cfg
    enc = cfg.family in encdec.FAMILIES

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        if enc:
            logits, aux = model.forward_train(params, tokens, be,
                                              batch["src_embeds"])
        else:
            logits, aux = model.forward_train(params, tokens, be,
                                              batch.get("prefix_embeds"))
        if cfg.frontend == "vision":
            logits = logits[:, cfg.frontend_tokens:]
        labels = batch.get("labels")
        if labels is None:
            labels = torch.cat([tokens[:, 1:],
                                torch.full_like(tokens[:, :1], -1)], dim=1)
        ce, n = _xent(logits, labels, cfg.vocab, tc.z_loss)
        return ce + aux, {"ce": ce, "aux": aux, "tokens": n}

    return loss_fn


def _split_micro(batch: Dict[str, torch.Tensor],
                 accum: int) -> List[Dict[str, torch.Tensor]]:
    """The batch cut along its batch dim into ``accum`` equal
    microbatches (a batch they do not divide raises, as the reference's
    reshape does)."""
    parts = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
             for k, v in batch.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(accum)]


def cast_params_for_compute(params: nn.Module,
                            cfg: ModelConfig) -> nn.Module:
    """f32 master -> the step's working copy, whose leaves require grad.

    Every floating leaf of rank >= 2 but the MoE router goes to the
    compute dtype; precision-sensitive leaves stay as they are: the
    per-layer vectors (norms, ``A_log``, ``dt_bias``, ``D``, ``conv_b``)
    and the router.  The port keeps one module per layer, so a leaf's
    rank is its per-layer rank, the rule the reference documents (its
    check on layer-stacked leaves casts the vectors too: ROADMAP §3).
    A leaf that keeps its dtype shares the master's storage."""
    dt = cfg.compute_dtype

    def cast(name, p):
        p = p.detach()
        if not p.is_floating_point() or p.ndim < 2 or "router" in name:
            return p
        return p.to(dt)
    return map_params(params, cast, requires_grad=True)


def make_train_step(model: Model, tc: TrainConfig, be: Policy) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    are ``loss`` and ``grad_norm`` (device scalars) and ``lr``.

    With ``accum_steps > 1`` the batch is split along the batch dim and
    the gradients are accumulated in f32, one backward a microbatch."""
    loss_fn = make_loss_fn(model, tc, be)

    def grads_of(pc: nn.Module, batch):
        names, leaves = zip(*pc.named_parameters())
        loss, _ = loss_fn(pc, batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                               for n, p, g in zip(names, leaves, gs)}

    def train_step(state, batch):
        params = state["params"]
        pc = cast_params_for_compute(params, model.cfg)
        if tc.accum_steps > 1:
            gsum, lsum = None, 0.0
            for mb in _split_micro(batch, tc.accum_steps):
                loss, g = grads_of(pc, mb)
                gsum = {n: v.float() if gsum is None else gsum[n] + v.float()
                        for n, v in g.items()}
                lsum = lsum + loss
            grads = {n: v / tc.accum_steps for n, v in gsum.items()}
            loss = lsum / tc.accum_steps
        else:
            loss, grads = grads_of(pc, batch)
        params, opt_state, om = opt.adamw_update(
            params, grads, state["opt"], state["step"], tc.opt)
        return ({"params": params, "opt": opt_state,
                 "step": state["step"] + 1}, {"loss": loss, **om})

    return train_step


# --------------------------------------------------------------------------
# The state as the JAX package's tree (checkpoints).
# --------------------------------------------------------------------------

def _family(cfg: ModelConfig):
    return encdec if cfg.family in encdec.FAMILIES else lm


def state_to_numpy(state: Dict[str, Any],
                   cfg: ModelConfig) -> Dict[str, Any]:
    """The train state as the reference's (``init_train_state``'s tree):
    params, m and v through ``params_to_numpy``, the step an int32
    scalar; host copies, so training may go on while they are written."""
    to_np = _family(cfg).params_to_numpy
    return {"params": to_np(state["params"], cfg),
            "opt": {"m": to_np(state["opt"]["m"], cfg),
                    "v": to_np(state["opt"]["v"], cfg)},
            "step": np.asarray(state["step"], np.int32)}


def state_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                     device="cuda") -> Dict[str, Any]:
    """The inverse of :func:`state_to_numpy`: the port's train state on
    ``device``, every leaf in f32."""
    def load(t):
        return _family(cfg).params_from_numpy(t, cfg, device, torch.float32)
    return {"params": load(tree["params"]),
            "opt": {"m": load(tree["opt"]["m"]), "v": load(tree["opt"]["v"])},
            "step": int(tree["step"])}
