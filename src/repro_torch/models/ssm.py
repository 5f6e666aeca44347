"""Mamba-2 block (SSD): attention-free sequence mixing (counterpart of
``repro/models/ssm.py``).

:func:`mamba` over a whole sequence is the ``forward_train`` path: the SSD
kernel (``kernels/ssd.py``) when the policy's non-GEMM family is the
kernel (``Policy.use_kernels``), else the chunked oracle ``ref.ref_ssd``
(the trainer's path: the kernel has no backward).  Every serving path
(wave prefill, wave decode, paged prefill chunks, paged slot decode) runs
ONE recurrence with an explicit carry, :func:`paged_step`, token by
token through ``ref.ref_ssd_decode_step``, so the state after any token
is the same bits however the tokens were chunked: that is what makes the
paged engine token-identical to the wave oracle and recompute-resume
exact at temperature 0.  The short causal conv is ``d_conv`` shifted adds.

Parameters live in :class:`Mamba`.  The matmul weights (``in_proj``,
``out_proj``) are in the compute dtype, cast once at load as the rest of
the port's; ``conv_w``, ``conv_b`` and ``norm_w`` keep the parameter
dtype and ``A_log``, ``D``, ``dt_bias`` stay f32, as in the reference, so
the f32 ``conv_w`` promotes the conv output, and with it x, B and C of
the SSD scan, to f32 as the reference's does.  A train step's working
copy (``train/loop.py``) holds ``conv_w`` (rank 2) in the compute dtype,
as the reference's step does, and the f32 ``conv_b`` then does the
promoting.
"""
from __future__ import annotations

import math
import types
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from repro_torch.api import Policy
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ref, ssd
from repro_torch.launch import step_analyzer
from repro_torch.models.common import mm, rmsnorm
from repro_torch.parallel import spmd
from repro_torch.parallel.ctx import constrain

#: parameter names of one mamba mixer, in the reference's tree order
PARAMS = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w",
          "out_proj")
#: the matmul weights, stored in the compute dtype
MATMUL = ("in_proj", "out_proj")
#: kept in f32 whatever the parameter dtype
F32 = ("A_log", "D", "dt_bias")


class Mamba(nn.Module):
    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for k in PARAMS:
            setattr(self, k, nn.Parameter(tensors[k], requires_grad=False))


def mamba_specs(cfg: ModelConfig):
    """Logical axes of one mixer's parameters (the reference's)."""
    return {"in_proj": ("embed", "inner"), "conv_w": (None, "inner"),
            "conv_b": ("inner",), "A_log": ("ssm_heads",),
            "D": ("ssm_heads",), "dt_bias": ("ssm_heads",),
            "norm_w": ("inner",), "out_proj": ("inner", "embed")}


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def init_mamba(cfg: ModelConfig, ninit: Callable, generator: torch.Generator,
               device="cuda") -> Mamba:
    """Random weights with the reference's shapes and scales: ``ninit``
    draws the two matmul weights in the compute dtype, ``conv_w`` in the
    parameter dtype; A, D and dt_bias follow ``init_mamba``'s formulas."""
    s = cfg.ssm
    d, di, N, nh = cfg.d_model, cfg.d_inner, s.d_state, cfg.ssm_heads
    ch = di + 2 * N
    pdt = cfg.param_torch_dtype

    def uniform(n):
        return torch.rand((n,), generator=generator, device=device,
                          dtype=torch.float32)

    dt = torch.exp(uniform(nh) * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    return Mamba(
        in_proj=ninit((d, 2 * di + 2 * N + nh), 1.0 / math.sqrt(d)),
        conv_w=ninit((s.d_conv, ch), 0.2, pdt),
        conv_b=torch.zeros((ch,), dtype=pdt, device=device),
        A_log=torch.log(torch.abs(uniform(nh) * 15 + 1)),
        D=torch.ones((nh,), dtype=torch.float32, device=device),
        dt_bias=torch.log(torch.expm1(dt)),
        norm_w=torch.ones((di,), dtype=pdt, device=device),
        out_proj=ninit((di, d), 1.0 / math.sqrt(di)
                       / math.sqrt(2.0 * cfg.n_layers)))


def _causal_conv(x, w, b):
    """Depthwise causal conv via shifted adds. x: (B, S, ch); w: (K, ch)."""
    K, S = w.shape[0], x.shape[1]
    out = x * w[-1][None, None, :]
    for i in range(1, K):
        shifted = torch.nn.functional.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[K - 1 - i][None, None, :]
    return out + b[None, None, :]


def _conv_chunk(conv_state, x, w, b):
    """Causal conv over a chunk with explicit left context.

    conv_state: (B, K-1, ch), the last K-1 inputs before this chunk;
    x: (B, C, ch).  Returns per-position outputs (B, C, ch) in the
    serving numerics (f32 window sum + bias, cast back)."""
    K, C = w.shape[0], x.shape[1]
    full = torch.cat([conv_state.to(x.dtype), x], dim=1)
    win = torch.stack([full[:, i:i + C] for i in range(K)], dim=2)
    y = torch.einsum("btkc,kc->btc", win.float(), w.float()) + b.float()
    return y.to(x.dtype)


def mamba(p: Mamba, x, be: Policy, cfg: ModelConfig,
          state: Optional[Tuple] = None):
    """Train/score path over whole sequences.  x: (B, S, d) -> y (B, S, d).

    With ``state`` (decode, S == 1) returns (y, new_state), state =
    (conv_state, ssm_h): a one-token chunk of the serving recurrence."""
    if state is not None:
        return paged_step(p, x, be, cfg, state)
    if spmd.is_dtensor(x):
        return _sharded_mamba(p, x, be, cfg)
    y = _mix(p, mm(x, p.in_proj, be), x.dtype, be, cfg)
    return mm(rmsnorm(y, p.norm_w, cfg.norm_eps), p.out_proj, be)


def _split(proj, cfg: ModelConfig):
    """in_proj's output (B, S, 2·di + 2·N + nh) as (z, x, B, C, dt)."""
    di, N = cfg.d_inner, cfg.ssm.d_state
    return torch.split(proj, [di, di, N, N, cfg.ssm_heads], dim=-1)


def _mix(p, proj, x_dtype, be: Policy, cfg: ModelConfig):
    """in_proj's output -> the gated y (B, S, di) that the norm and
    out_proj read (:func:`_gated` of its parts)."""
    return _gated(p, *_split(proj, cfg), x_dtype, be, cfg)


def _gated(p, z, xs, Bm, Cm, dt, x_dtype, be: Policy, cfg: ModelConfig):
    """The conv, the SSD scan (the kernel or ``ref_ssd``) and the gate
    over the heads ``xs`` and ``dt`` hold (every head on one rank, a
    rank's share under tensor parallelism: ``p`` holds the conv weights
    of [xs | B | C]'s channels and the per-head vectors of those heads)."""
    s = cfg.ssm
    B, S, di = xs.shape
    N, nh, P = Bm.shape[-1], dt.shape[-1], s.head_dim
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    A = -torch.exp(p.A_log)
    conv_out = constrain(_silu(_causal_conv(conv_in, p.conv_w, p.conv_b)),
                         "batch", None, "inner")
    # views into conv_out, no copies: the SSD kernel reads their strides
    xs_c = constrain(conv_out[..., :di].reshape(B, S, nh, P),
                     "batch", None, "ssm_heads", None)
    B_c = conv_out[..., di:di + N].reshape(B, S, 1, N)
    C_c = conv_out[..., di + N:].reshape(B, S, 1, N)
    dt_c = constrain(torch.nn.functional.softplus(dt.float() + p.dt_bias),
                     "batch", None, "ssm_heads")
    if be.use_kernels:
        y = ssd.ssd_scan(xs_c, dt_c, A, B_c, C_c, chunk=s.chunk)
        y = y.float() + p.D[None, None, :, None] * xs_c.float()
    else:
        y = ref.ref_ssd(xs_c, dt_c, A, B_c, C_c, D_skip=p.D,
                        chunk=s.chunk).float()
    y = y.reshape(B, S, di).to(x_dtype)
    return y * _silu(z.float()).to(x_dtype)


def _heads_layout(p: Mamba, x, be: Policy, cfg: ModelConfig):
    """The sharded mixer's common start (:func:`_sharded_mamba`,
    :func:`_sharded_paged_step`).  in_proj is column-parallel, and its
    output is made whole along the last dim (the split into z, x, B, C,
    dt crosses the shards).  Where ``inner`` is on a mesh dim that the
    heads divide, each rank takes its heads' share (a slice, no
    collective); elsewhere every head.  Returns (z, x, B, C, dt, z, x
    and dt laid out as the share, B and C whole; the placements of the
    share, of in_proj's output; the conv weights and per-head vectors
    of the share: conv_w's x and B/C columns, conv_b's, A_log, D,
    dt_bias, which :func:`_share` puts together)."""
    from torch.distributed.tensor import Replicate, Shard
    di, nh = cfg.d_inner, cfg.ssm_heads
    proj = spmd.settle(mm(x, p.in_proj, be))
    mesh, last = proj.device_mesh, proj.ndim - 1
    pl = tuple(Replicate() if q.is_shard(last) else q
               for q in proj.placements)
    if pl != tuple(proj.placements):
        proj = proj.redistribute(mesh, pl)
    tp = [q.is_shard(1) and nh % mesh.size(j) == 0
          for j, q in enumerate(p.in_proj.placements)]
    heads = tuple(Shard(last) if t else q for t, q in zip(tp, pl))
    cols = tuple(Shard(1) if t else Replicate() for t in tp)
    vec = tuple(Shard(0) if t else Replicate() for t in tp)
    z, xs, Bm, Cm, dt = _split(proj, cfg)
    z, xs, dt = (t.redistribute(mesh, heads) for t in (z, xs, dt))
    cw, cb = spmd.whole(p.conv_w), spmd.whole(p.conv_b)
    ws = [cw[:, :di].redistribute(mesh, cols), cw[:, di:],
          cb[:di].redistribute(mesh, vec), cb[di:]] + [
        spmd.whole(getattr(p, k)).redistribute(mesh, vec)
        for k in ("A_log", "D", "dt_bias")]
    return (z, xs, Bm, Cm, dt), (heads, pl), ws


def _share(cw_x, cw_bc, cb_x, cb_bc, A_log, D, dt_bias):
    """A rank's share of the mixer's weights (:func:`_heads_layout`'s) as
    the ``p`` that :func:`_gated` and :func:`_recur` read."""
    return types.SimpleNamespace(conv_w=torch.cat([cw_x, cw_bc], 1),
                                 conv_b=torch.cat([cb_x, cb_bc]),
                                 A_log=A_log, D=D, dt_bias=dt_bias)


def _sharded_mamba(p: Mamba, x, be: Policy, cfg: ModelConfig):
    """:func:`mamba` on DTensors: each rank runs the conv, the scan and
    the gate on its heads' share (:func:`_heads_layout`); the norm spans
    the ranks' shares, and out_proj is row-parallel."""
    parts, (heads, _), ws = _heads_layout(p, x, be, cfg)

    def body(z, xs, Bm, Cm, dt, *w):
        return _gated(_share(*w), z, xs, Bm, Cm, dt, x.dtype, be, cfg)
    y = spmd.local(body, heads, *parts, *ws)
    return mm(rmsnorm(y, p.norm_w, cfg.norm_eps), p.out_proj, be)


# --------------------------------------------------------------------------
# Serving recurrence (paged engine + wave oracle share this path).
# --------------------------------------------------------------------------

def init_paged_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device="cuda"):
    """Zero recurrent carry for ONE mamba layer and ``batch`` rows (one
    row per engine slot): (conv carry (batch, d_conv-1, ch), SSM state
    (batch, nh, P, N) in f32).  Fixed-size per row: slot-lifetime, not
    token-proportional."""
    s = cfg.ssm
    ch = cfg.d_inner + 2 * s.d_state
    conv = torch.zeros((batch, s.d_conv - 1, ch), dtype=dtype, device=device)
    h = torch.zeros((batch, cfg.ssm_heads, s.head_dim, s.d_state),
                    dtype=torch.float32, device=device)
    return conv, h


def paged_step(p: Mamba, x, be: Policy, cfg: ModelConfig, state: Tuple, *,
               seg_len: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None):
    """One mamba layer over a token chunk with an explicit carry: THE
    serving-path numerics.  x: (B, C, d); state = (conv_state
    (B, K-1, ch), h (B, nh, P, N)).

    ``seg_len`` (B,) marks how many of the C positions are real tokens (a
    prefill chunk's tail past the prompt is padding); ``active`` (B,)
    bool masks rows whose carry must not move (idle slots sharing the
    decode batch).  Masked positions advance neither the conv carry (the
    new carry is the last K-1 valid inputs) nor the SSM state (dt is
    zeroed, so exp(dt*A) = 1 and the input term vanishes), and both are
    re-selected through ``torch.where`` so inactive rows stay bitwise
    untouched.  Each valid token undergoes exactly the ops of the
    one-token decode step, in a Python loop over the chunk, so chunking
    is invisible to the carry.  Returns (y (B, C, d), (conv', h')).
    On meta tensors under a counting ``step_analyzer.StepCounter`` (the
    dry run) the loop's body runs twice, the second run counted C - 1
    times.  On DTensors (the wave path on several ranks) see
    :func:`_sharded_paged_step`."""
    if spmd.is_dtensor(x):
        if seg_len is not None or active is not None:
            raise NotImplementedError("paged_step on DTensors: the wave "
                                      "path only (no seg_len, no active)")
        return _sharded_paged_step(p, x, be, cfg, state)
    z, xs, Bm, Cm, dt = _split(mm(x, p.in_proj, be), cfg)
    y, new = _recur(p, z, xs, Bm, Cm, dt, state, cfg, x.dtype, seg_len,
                    active)
    return mm(rmsnorm(y, p.norm_w, cfg.norm_eps), p.out_proj, be), new


def _recur(p, z, xs, Bm, Cm, dt, state: Tuple, cfg: ModelConfig, x_dtype,
           seg_len=None, active=None):
    """:func:`paged_step` between in_proj and the norm, over the heads
    ``xs`` and ``dt`` hold (all, or a rank's share: ``p`` then holds the
    conv weights of [xs | B | C]'s channels and those heads' vectors, and
    the carry those channels and heads).  Returns (the gated y (B, C,
    di) in ``x_dtype``, (conv', h'))."""
    s = cfg.ssm
    B, C, di = xs.shape
    N, nh, P = Bm.shape[-1], dt.shape[-1], s.head_dim
    conv_state, h = state
    dev = xs.device
    if seg_len is None:
        seg_len = torch.full((B,), C, dtype=torch.long, device=dev)
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)                 # (B, C, ch)
    A = -torch.exp(p.A_log)
    conv_out = _silu(_conv_chunk(conv_state, conv_in, p.conv_w, p.conv_b))
    xs_c = conv_out[..., :di].reshape(B, C, nh, P)
    B_c = conv_out[..., di:di + N].float()                    # (B, C, N)
    C_c = conv_out[..., di + N:].float()
    dt_c = torch.nn.functional.softplus(dt.float()
                                        + p.dt_bias[None, None, :])
    valid = (torch.arange(C, device=dev)[None, :] < seg_len[:, None]) \
        & active[:, None]                                     # (B, C)
    dt_m = torch.where(valid[..., None], dt_c, torch.zeros((), device=dev))
    xf = xs_c.float()
    y = torch.empty((B, C, nh, P), dtype=torch.float32, device=dev)
    hc, t0 = h, 0
    if dev.type == "meta" and step_analyzer.trip_counting() and C > 2:
        # the dry run: the C alike iterations counted as two body runs,
        # the second C - 1 times (the reference's lax.scan trip count);
        # the second holds the previous carry live as every later
        # iteration does, so the peak of live bytes is the loop's too
        hc, y_t = ref.ref_ssd_decode_step(hc, xf[:, 0], dt_m[:, 0], A,
                                          B_c[:, 0], C_c[:, 0])
        y[:, 0] = y_t
        with step_analyzer.trip_count(C - 1):
            hc, y_t = ref.ref_ssd_decode_step(hc, xf[:, 1], dt_m[:, 1], A,
                                              B_c[:, 1], C_c[:, 1])
            y[:, 1] = y_t
        t0 = C
    for t in range(t0, C):
        hc, y_t = ref.ref_ssd_decode_step(hc, xf[:, t], dt_m[:, t], A,
                                          B_c[:, t], C_c[:, t])
        y[:, t] = y_t
    y = y + p.D[None, None, :, None] * xf
    y = y.reshape(B, C, di).to(x_dtype) * _silu(z.float()).to(x_dtype)
    # conv carry: rows [seg_len, seg_len + K-1) of [carry ; chunk] are the
    # last K-1 inputs at or before the segment end
    Kc = s.d_conv - 1
    full = torch.cat([conv_state.to(conv_in.dtype), conv_in], dim=1)
    idx = seg_len[:, None] + torch.arange(Kc, device=dev)[None, :]
    conv_new = torch.gather(full, 1, idx[..., None].expand(-1, -1,
                                                           full.shape[-1]))
    conv_new = torch.where(active[:, None, None],
                           conv_new.to(conv_state.dtype), conv_state)
    h_new = torch.where(active[:, None, None, None], hc, h)
    return y, (conv_new, h_new)


def _sharded_paged_step(p: Mamba, x, be: Policy, cfg: ModelConfig,
                        state: Tuple):
    """:func:`paged_step` on DTensors, split as the training mixer
    (:func:`_heads_layout`): each rank runs the conv and the recurrence
    on its heads' share, with the conv carry's x channels and the SSM
    state's heads of that share.  The conv carry is gathered whole first
    (the cache splits its channels evenly, which does not follow the
    heads), and both new carries go back in the carry's layout.  The
    norm spans the ranks' shares; out_proj is row-parallel."""
    from torch.distributed.tensor import Shard
    di = cfg.d_inner
    conv, h = state
    parts, (heads, pl), ws = _heads_layout(p, x, be, cfg)
    mesh = parts[0].device_mesh
    # the SSM state's heads split where the share's are
    rows = tuple(Shard(1) if q.is_shard(2) else q for q in heads)
    conv_pl, h_pl = tuple(conv.placements), tuple(h.placements)
    conv = conv.redistribute(mesh, pl)
    h = h.redistribute(mesh, rows) if h_pl != rows else h
    cx = conv[..., :di].redistribute(mesh, heads)

    def body(z, xs, Bm, Cm, dt, cx, cbc, h, *w):
        y, (c, hn) = _recur(_share(*w), z, xs, Bm, Cm, dt,
                            (torch.cat([cx, cbc], -1), h), cfg, x.dtype)
        return y, c[..., :cx.shape[-1]], c[..., cx.shape[-1]:], hn
    y, cx, cbc, h = spmd.local(body, (heads, heads, pl, rows), *parts, cx,
                               conv[..., di:], h, *ws)
    conv = torch.cat([cx.redistribute(mesh, pl), cbc], -1)
    if tuple(conv.placements) != conv_pl:
        conv = conv.redistribute(mesh, conv_pl)
    if tuple(h.placements) != h_pl:
        h = h.redistribute(mesh, h_pl)
    out = mm(rmsnorm(y, p.norm_w, cfg.norm_eps), p.out_proj, be)
    return out, (conv, h)
