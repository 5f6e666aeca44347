"""Plain reference of a sparse-expert decoder (Mixtral): the forward pass
and the served-token check, in f32 with TF32 off, written from the
equations and importing nothing of the program.

  x_0 = E[t]                                   E: (V_rows, d)
  h   = x + Wo · attn(rope(norm1(x) Wq), rope(norm1(x) Wk), norm1(x) Wv)
  p   = softmax(norm2(h) Wr)                   Wr: (d, n_experts), f32
  x'  = h + sum over the top-k experts e of p (p_e / sum of the top-k)
            · Wd_e (silu(norm2(h) Wg_e) * norm2(h) Wu_e)
  logits = norm(x_L) Wh                        untied head

norm is RMSNorm with its gain; RoPE, causal grouped-query attention and
the head are the dense reference's (``reference/dense.py``).  The MoE is
Hugging Face's ``MixtralSparseMoeBlock``: the router's softmax over every
expert, the top-k, renormalised, and each expert applied to exactly the
tokens routed to it; no capacity, nothing dropped.

Layers run one at a time, each drawn again from the seed as the
program serves it (bf16 values, widened to f32 here) and freed before
the next: the weights of a stage do not fit beside themselves in f32.
``num="fp8"`` is the control: every matmul (router included) on
operands rounded to float8_e4m3 with one scale a tensor.

The check (:func:`served_gaps`).  With random weights many tokens sit
near a routing tie: where the reference's second and third router
scores are close, bf16 rounding alone may swap an expert, and that
token's logits then differ by far more than rounding.  Such tokens
cannot tell a sound bf16 run from a wrong one, so the check reads the
mean served-token gap over the tokens whose every layer keeps a margin
of at least :data:`STABLE_MARGIN` between its second and third router
logit in the reference (``stable_mean_gap``), and how many were left
out (``excluded_share``: a guard, so that a check whose mean runs over
too few tokens fails; the margins are the reference's, so the control
and the faults leave it as a sound run does).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import weights
from perfbench.reference.dense import (_stats, attention, exact_f32, head,
                                       mm, rmsnorm)

#: the least gap between a token's second and third router logit, in
#: every layer, for its served-token gap to count (``stable_mean_gap``):
#: above the router-logit drift that bf16 rounding of the residual stream
#: gives at the cell's depth, so a stable token's experts are the
#: reference's in a sound run.  At mixtral-8x22b's widths and 8 layers it
#: leaves out 55-64 % of the served tokens (21 seeds), and a sound run's
#: mean over the rest reads 0.0005-0.009 against the fp8 control's
#: 0.145-0.255 (6 seeds; PERF.md §2)
STABLE_MARGIN = 0.05


def experts(x, w, doc, num: str):
    """The MoE over x (S, d): y (S, d) and each token's margin between
    its k-th and (k+1)-th router logit (S,)."""
    k = doc["moe"]["top_k"]
    logits = mm(x, w["moe.router"], num)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    srt = torch.sort(logits, dim=-1, descending=True).values
    margin = srt[:, k - 1] - srt[:, k]
    y = torch.zeros_like(x)
    for e in range(doc["moe"]["num_experts"]):
        tok, slot = torch.nonzero(top_e == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = F.silu(mm(xe, w["moe.w_gate"][e], num)) * \
            mm(xe, w["moe.w_up"][e], num)
        y.index_add_(0, tok, top_p[tok, slot, None]
                     * mm(h, w["moe.w_down"][e], num))
    return y, margin


def block(x, w, doc, num: str):
    eps = doc["norm_eps"]
    h = x + attention(rmsnorm(x, w["ln1"], eps), w, doc, num)
    y, margin = experts(rmsnorm(h, w["ln2"], eps), w, doc, num)
    return h + y, margin


def forward(doc, seed: int, seqs: Sequence[torch.Tensor], device,
            nums: Sequence[str] = ("f32",)):
    """(logits {num: [(S_i, V_rows) f32]}, margins [(S_i,)]): each
    sequence's logits for each numerics in ``nums``, and each position's
    smallest router margin over the layers in the f32 pass."""
    wdt = getattr(torch, doc["dtype"])
    with torch.no_grad(), exact_f32():
        o = weights.outer(doc, seed, wdt, device)
        xs = {n: [o["embed"][s.to(device)].float() for s in seqs]
              for n in nums}
        margins: List[torch.Tensor] = [
            torch.full((len(s),), float("inf"), device=device) for s in seqs]
        for i in range(doc["n_layers"]):
            w = weights.layer(doc, seed, i, wdt, device)
            for n in nums:
                out = [block(x, w, doc, n) for x in xs[n]]
                xs[n] = [x for x, _ in out]
                if n == "f32":
                    margins = [torch.minimum(a, mg)
                               for a, (_, mg) in zip(margins, out)]
            del w
        return ({n: [head(x, o, doc, n) for x in xs[n]] for n in nums},
                margins)


def logits(doc, seed: int, seqs: Sequence[torch.Tensor], device,
           nums: Sequence[str] = ("f32",)) -> Dict[str, List[torch.Tensor]]:
    """Logits (S_i, V_rows) f32 of each token sequence, for each
    numerics in ``nums`` (:func:`forward`)."""
    return forward(doc, seed, seqs, device, nums)[0]


def _stable(gaps: torch.Tensor, ok: torch.Tensor, pre: str):
    """The mean gap over the stable tokens (inf where none is) and the
    share left out, with the dense check's statistics over every token
    beside them."""
    out = _stats(gaps, pre)
    out[pre + "stable_mean_gap"] = float(gaps[ok].mean()) if ok.any() \
        else float("inf")
    out[pre + "excluded_share"] = float(1.0 - ok.float().mean())
    return out


def served_gaps(doc, seed: int, served, device,
                control: bool = False) -> Dict[str, float]:
    """How far each served token's logit lies below the reference's best
    at its position, over ``served`` [(prompt, tokens)]: the mean over
    the routing-stable positions (``stable_mean_gap``), the share of
    positions left out (``excluded_share``), and the widest gap, its
    95th percentile and its mean over all; with ``control`` the same of
    the token the fp8 reference puts first at each of those positions,
    under ``control_``."""
    seqs, spans = [], []
    for prompt, out in served:
        full = np.concatenate([np.asarray(prompt), np.asarray(out[:-1])])
        seqs.append(torch.as_tensor(full, dtype=torch.long))
        spans.append((len(prompt) - 1, torch.as_tensor(np.asarray(out),
                                                       dtype=torch.long)))
    nums = ("f32", "fp8") if control else ("f32",)
    lg, margins = forward(doc, seed, seqs, device, nums)
    gaps, ctl, ok = [], [], []
    for i, (p0, out) in enumerate(spans):
        ref = lg["f32"][i][p0:p0 + len(out)]
        best = ref.max(-1).values
        gaps.append(best - ref.gather(-1, out.to(ref.device)[:, None])[:, 0])
        ok.append(margins[i][p0:p0 + len(out)] >= STABLE_MARGIN)
        if control:
            pick = lg["fp8"][i][p0:p0 + len(out)].argmax(-1)
            ctl.append(best - ref.gather(-1, pick[:, None])[:, 0])
    ok_all = torch.cat(ok).cpu()
    res = _stable(torch.cat(gaps).float().cpu(), ok_all, "")
    if control:
        res.update(_stable(torch.cat(ctl).float().cpu(), ok_all, "control_"))
    return res
