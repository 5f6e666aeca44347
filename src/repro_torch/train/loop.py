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
from repro_torch.parallel import spmd
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


def _xent_tail(lse, ll, labels, vocab: int, z_loss: float):
    """(the sum of the per-token losses, the count of valid tokens) from
    each token's logsumexp and label logit."""
    valid = (labels >= 0) & (labels < vocab)
    per_tok = (lse - ll) + z_loss * lse ** 2
    per_tok = torch.where(valid, per_tok, torch.zeros((), device=lse.device))
    return per_tok.sum(), valid.sum()


def _xent(logits, labels, vocab: int, z_loss: float):
    """Masked cross-entropy in f32 + z-loss; labels == -1 are ignored.  The
    logsumexp runs over the padded vocabulary, as the reference's.  On
    DTensors the vocabulary stays sharded (:func:`_sharded_xent`)."""
    if spmd.any_dtensor(logits, labels):
        tot, cnt = _sharded_xent(logits, labels, vocab, z_loss)
    else:
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1,
                          labels.clamp(0, vocab - 1)[..., None])[..., 0]
        tot, cnt = _xent_tail(lse, ll, labels, vocab, z_loss)
    n = torch.clamp(cnt, min=1)
    return tot / n, n


def _sharded_xent(logits, labels, vocab: int, z_loss: float):
    """The loss sums over vocab-sharded logits, the vocabulary never
    gathered: each rank's row maximum, reduced (max); each rank's sum of
    exp(logit - max) and the label's logit where it holds it (0 where
    not), reduced (sum); then each rank's rows, summed and reduced once
    over the batch axes.  Only (B, S) statistics cross the ranks."""
    from torch.distributed.tensor import Partial, Replicate
    logits = spmd.settle(logits)
    mesh, last = logits.device_mesh, logits.ndim - 1
    pl = tuple(logits.placements)
    row = tuple(Replicate() if q.is_shard(last) else q for q in pl)
    row_sum = tuple(Partial() if q.is_shard(last) else q for q in pl)
    row_max = tuple(Partial("max") if q.is_shard(last) else q for q in pl)
    lo = spmd.local_offset(logits.shape, mesh, pl)[last]
    m = spmd.local(lambda lg: lg.detach().float().amax(-1), row_max,
                   logits).redistribute(mesh, row)

    def pieces(lg, mx, lb):
        lf = lg.float()
        sumexp = torch.exp(lf - mx[..., None]).sum(-1)
        idx = lb - lo
        held = (idx >= 0) & (idx < lf.shape[-1])
        pick = torch.gather(lf, -1, idx.clamp(0, lf.shape[-1] - 1)[..., None])
        return sumexp, torch.where(held, pick[..., 0],
                                   torch.zeros((), device=lf.device))
    sumexp, ll = spmd.local(pieces, (row_sum, row_sum), logits, m, labels)
    lse = torch.log(spmd.settle(sumexp)) + m
    red = tuple(Partial() if q.is_shard() else q for q in row)
    tot, cnt = spmd.local(
        lambda a, b, c: _xent_tail(a, b, c, vocab, z_loss), (red, red), lse,
        spmd.settle(ll), labels)
    return spmd.settle(tot), spmd.settle(cnt)


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
    reshape does).  A batch-sharded DTensor is cut on each rank: each
    rank's local rows go into ``accum`` microbatches, so every
    microbatch holds rows of every batch shard, the same count of each
    (the reference reshapes the global rows, which its ``lax.scan`` over
    a batch-sharded dim refuses).  Where ``accum`` does not divide the
    local rows, the batch is gathered whole and cut as one rank cuts it,
    each microbatch then replicated over the batch axes."""
    if any(spmd.is_dtensor(v) for v in batch.values()):
        def cut(v):
            loc = v.to_local()
            n = loc.shape[0] // accum
            if n * accum != loc.shape[0]:
                v = v.redistribute(v.device_mesh,
                                   spmd.replicate(v.device_mesh))
                m = v.shape[0] // accum
                return [v[i * m:(i + 1) * m] for i in range(accum)]
            shape = (v.shape[0] // accum,) + tuple(v.shape[1:])
            return [spmd.from_local(loc[i * n:(i + 1) * n], v.device_mesh,
                                    v.placements, shape)
                    for i in range(accum)]
        parts = {k: cut(v) for k, v in batch.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(accum)]
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
    A leaf that keeps its dtype shares the master's storage; a DTensor
    leaf keeps its placements."""
    dt = cfg.compute_dtype

    def cast(name, p):
        p = p.detach()
        if not p.is_floating_point() or p.ndim < 2 or "router" in name:
            return p
        return p.to(dt)
    return map_params(params, cast, requires_grad=True)


def _like(g, p):
    """A gradient in its parameter's placements (a DTensor gradient may
    come back ``Partial`` or laid out otherwise); a plain one as it is."""
    if spmd.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(model: Model, tc: TrainConfig, be: Policy) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    are ``loss`` and ``grad_norm`` (device scalars) and ``lr``.

    With ``accum_steps > 1`` the batch is split along the batch dim and
    the gradients are accumulated in f32, one backward a microbatch.

    On several ranks the state's leaves are DTensors laid out by the
    rules (``Rules.distribute``) and the batch a batch-sharded DTensor
    (``data.make_global_batch``); the same step runs, each GEMM on its
    rank's shards, each gradient in its parameter's placements.  The loss
    comes back as a plain, replicated scalar.

    Inside an ``obs.capture`` a step is the span ``train.step``, with
    ``train.grads`` (loss, forward and backward; its device time too) and
    AdamW's ``train.optimizer`` in it."""
    loss_fn = make_loss_fn(model, tc, be)

    def grads_of(pc: nn.Module, batch):
        with obs.span("train.grads", device=True):
            names, leaves = zip(*pc.named_parameters())
            loss, _ = loss_fn(pc, batch)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
            return loss.detach(), {n: torch.zeros_like(p) if g is None
                                   else _like(g, p)
                                   for n, p, g in zip(names, leaves, gs)}

    def train_step(state, batch):
        with obs.span("train.step"):
            return _train_step(state, batch)

    def _train_step(state, batch):
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
        if spmd.is_dtensor(loss):
            loss = loss.full_tensor()
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
