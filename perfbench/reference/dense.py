"""Plain reference of a dense decoder (OLMo): the forward pass, greedy
served-token logits and the train step, in f32 with TF32 off, written
from the equations and importing nothing of the program.

  x_0 = E[t]                                   E: (V_rows, d)
  h   = x + Wo · attn(rope(norm(x) Wq), rope(norm(x) Wk), norm(x) Wv)
  x'  = h + Wd (silu(norm(h) Wg) * norm(h) Wu)
  logits = norm(x_L) E^T    (tied; an untied head Wh otherwise)

norm is RMSNorm (x / sqrt(mean(x^2) + eps), times a weight where the
configuration has one); RoPE rotates the two halves of each head
(theta^(-i/half)); attention is causal, grouped-query, softmax(q k^T /
sqrt(hd)), with a sliding window where the configuration has one.

Layers run one at a time, each drawn again from the seed
(``perfbench.weights``), so a model larger than what fits beside the
program still fits alone.  ``num="fp8"`` is the control: every matmul
of a projection and the head on operands rounded to float8_e4m3 with
one scale a tensor (amax to 448).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import weights

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """TF32 off for every matmul inside."""
    m, c = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def q8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8_e4m3 under one scale (amax -> 448), back in
    f32; the gradient passes straight through."""
    s = FP8_MAX / t.detach().abs().amax().clamp(min=1e-30)
    r = (t.detach() * s).to(torch.float8_e4m3fn).float() / s
    return t + (r - t.detach())


def mm(x: torch.Tensor, w: torch.Tensor, num: str) -> torch.Tensor:
    x, w = x.float(), w.float()
    if num == "fp8":
        x, w = q8(x), q8(w)
    elif num != "f32":
        raise ValueError(f"numerics {num!r}: f32 or fp8")
    return x @ w


def rmsnorm(x, w, eps: float):
    y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return y if w is None else y * w.float()


def rope(x, pos, theta: float):
    """x (S, H, hd), pos (S,)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos.float()[:, None, None] * freq
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(x, w, doc, num: str):
    """Causal self-attention over the whole sequence x (S, d)."""
    S = x.shape[0]
    H, Hkv, hd = doc["n_heads"], doc["n_kv_heads"], doc["head_dim"]
    pos = torch.arange(S, device=x.device)
    q = rope(mm(x, w["attn.wq"], num).view(S, H, hd), pos, doc["rope_theta"])
    k = rope(mm(x, w["attn.wk"], num).view(S, Hkv, hd), pos,
             doc["rope_theta"])
    v = mm(x, w["attn.wv"], num).view(S, Hkv, hd)
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    ok = pos[None, :] <= pos[:, None]
    window = doc["attn"].get("window")
    if window is not None:
        ok = ok & (pos[None, :] > pos[:, None] - window)
    s = s.masked_fill(~ok, float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
    return mm(o.reshape(S, H * hd), w["attn.wo"], num)


def mlp(x, w, doc, num: str):
    return mm(F.silu(mm(x, w["mlp.wg"], num)) * mm(x, w["mlp.wu"], num),
              w["mlp.wd"], num)


def block(x, w, doc, num: str):
    eps = doc["norm_eps"]
    h = x + attention(rmsnorm(x, w.get("ln1"), eps), w, doc, num)
    return h + mlp(rmsnorm(h, w.get("ln2"), eps), w, doc, num)


def head(x, o, doc, num: str):
    x = rmsnorm(x, o.get("final_norm"), doc["norm_eps"])
    w = o["embed"].t() if doc["tie_embeddings"] else o["unembed"]
    return mm(x, w, num)


def logits(doc, seed: int, seqs: Sequence[torch.Tensor], device,
           nums: Sequence[str] = ("f32",)) -> Dict[str, List[torch.Tensor]]:
    """Logits (S_i, V_rows) f32 of each token sequence, for each numerics
    in ``nums``, the weights drawn as the program serves them (the
    configuration's dtype) and widened to f32, one layer at a time."""
    wdt = getattr(torch, doc["dtype"])
    with torch.no_grad(), exact_f32():
        o = weights.outer(doc, seed, wdt, device)
        xs = {n: [o["embed"][s.to(device)].float() for s in seqs]
              for n in nums}
        for i in range(doc["n_layers"]):
            w = weights.layer(doc, seed, i, wdt, device)
            for n in nums:
                xs[n] = [block(x, w, doc, n) for x in xs[n]]
            del w
        return {n: [head(x, o, doc, n) for x in xs[n]] for n in nums}


def served_gaps(doc, seed: int, served, device,
                control: bool = False) -> Dict[str, float]:
    """How far each served token's logit lies below the reference's best
    at its position, over ``served`` [(prompt, tokens)]: the widest gap,
    its 95th percentile and its mean (:func:`_stats`); with ``control``
    the same of the token the fp8 reference puts first at each of those
    positions, under ``control_``."""
    seqs, spans = [], []
    for prompt, out in served:
        full = np.concatenate([np.asarray(prompt), np.asarray(out[:-1])])
        seqs.append(torch.as_tensor(full, dtype=torch.long))
        spans.append((len(prompt) - 1, torch.as_tensor(np.asarray(out),
                                                       dtype=torch.long)))
    nums = ("f32", "fp8") if control else ("f32",)
    lg = logits(doc, seed, seqs, device, nums)
    gaps, ctl = [], []
    for i, (p0, out) in enumerate(spans):
        ref = lg["f32"][i][p0:p0 + len(out)]
        best = ref.max(-1).values
        gaps.append(best - ref.gather(-1, out.to(ref.device)[:, None])[:, 0])
        if control:
            pick = lg["fp8"][i][p0:p0 + len(out)].argmax(-1)
            ctl.append(best - ref.gather(-1, pick[:, None])[:, 0])
    out = _stats(torch.cat(gaps), "")
    if control:
        out.update(_stats(torch.cat(ctl), "control_"))
    return out


def _stats(g: torch.Tensor, pre: str) -> Dict[str, float]:
    """The widest gap, its 95th percentile and its mean, over tokens."""
    g = g.float().cpu()
    return {pre + "max_gap": float(g.max()),
            pre + "p95_gap": float(torch.quantile(g, 0.95)),
            pre + "mean_gap": float(g.mean())}


# --------------------------------------------------------------------------
# Training: cross-entropy plus z-loss, AdamW with warmup-cosine and
# global-norm clipping, one sequence at a time (the gradients summed).
# --------------------------------------------------------------------------

def params(doc, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf, f32, requiring grad, under the names the port's
    module gives them (``blocks.<i>.attn.wq``, ``embed``, ...)."""
    out = {}
    for k, v in weights.outer(doc, seed, torch.float32, device).items():
        out[k] = v
    for i in range(doc["n_layers"]):
        for k, v in weights.layer(doc, seed, i, torch.float32,
                                  device).items():
            out[f"blocks.{i}.{k}"] = v
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in out.items()}


def _layer_view(p, i: int):
    pre = f"blocks.{i}."
    return {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}


def loss_sum(p, doc, tokens: torch.Tensor, z_loss: float, num: str):
    """Sum over one sequence's positions of CE + z_loss * lse^2 (the
    logsumexp over every row of the table; the last position has no
    label)."""
    x = p["embed"][tokens]
    for i in range(doc["n_layers"]):
        x = block(x, _layer_view(p, i), doc, num)
    lg = head(x, p, doc, num)[:-1]
    lse = torch.logsumexp(lg, dim=-1)
    ll = lg.gather(-1, tokens[1:, None])[:, 0]
    return ((lse - ll) + z_loss * lse * lse).sum()


def schedule(step: int, c) -> float:
    """Linear warmup to peak_lr, then cosine to min_lr_ratio of it; in
    f32, as the schedule's published form is evaluated by the trainer."""
    f = np.float32
    s = f(step)
    warm = f(c["peak_lr"]) * (s + f(1)) / f(max(c["warmup_steps"], 1))
    t = np.clip((s - f(c["warmup_steps"]))
                / f(max(c["decay_steps"] - c["warmup_steps"], 1)), f(0), f(1))
    cos = f(c["min_lr_ratio"]) + f(1 - c["min_lr_ratio"]) * f(0.5) \
        * (f(1) + np.cos(f(np.pi) * t))
    return float(np.minimum(warm, f(c["peak_lr"]) * cos))


def train_steps(doc, seed: int, batches: Sequence[torch.Tensor], opt,
                z_loss: float, device, num: str = "f32"):
    """Run len(batches) AdamW steps from the seeded f32 weights.
    Returns {"loss": [per step], "grad1": {leaf: |g| of the first
    clipped gradient}, "change": {leaf: |p_n - p_0|}, "gref": {leaf:
    |g| before clipping, step 1}}."""
    with exact_f32():
        p = params(doc, seed, device)
        p0 = {k: v.detach().clone() for k, v in p.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        losses, grad1, gref = [], {}, {}
        for step, batch in enumerate(batches):
            B, S = batch.shape
            n = B * (S - 1)
            total = 0.0
            for b in range(B):
                part = loss_sum(p, doc, batch[b].to(device), z_loss, num) / n
                part.backward()
                total += float(part.detach())
            losses.append(total)
            with torch.no_grad():
                g = {k: t.grad for k, t in p.items()}
                norm = torch.sqrt(sum((x * x).sum() for x in g.values()))
                scale = min(1.0, opt["clip_norm"] / (float(norm) + 1e-9))
                lr = schedule(step, opt)
                b1c = 1.0 - opt["b1"] ** (step + 1)
                b2c = 1.0 - opt["b2"] ** (step + 1)
                for k, t in p.items():
                    gk = g[k] * scale
                    if step == 0:
                        grad1[k] = float(gk.norm())
                        gref[k] = float(g[k].norm())
                    m[k].mul_(opt["b1"]).add_((1 - opt["b1"]) * gk)
                    v2[k].mul_(opt["b2"]).add_((1 - opt["b2"]) * gk * gk)
                    upd = (m[k] / b1c) / (torch.sqrt(v2[k] / b2c)
                                          + opt["eps"])
                    if t.ndim >= 2:
                        upd = upd + opt["weight_decay"] * t
                    t.sub_(lr * upd)
                    t.grad = None
        change = {k: float((p[k].detach() - p0[k]).norm()) for k in p}
        return {"loss": losses, "grad1": grad1, "change": change,
                "gref": gref}
