"""Plain PyTorch oracles (counterparts of ``repro/kernels/ref.py``).

The GEMM, grouped-GEMM, RMSNorm, attention and Mamba-2 SSD oracles, and
``f32_einsum``, the f32-accumulating einsum the model's plain attention
and MoE combine share.
``chunked_mha`` is also the model's library attention path
(``models/layers.py::_full_attn``), ``ref_ssd`` the model's library SSD
path (``models/ssm.py::mamba``) and ``ref_ssd_decode_step`` the serving
recurrence of every SSM serving path (``models/ssm.py::paged_step``).  The
GEMM oracles are kept independent of ``core/templates.py`` on purpose:
``ref_gemm`` rounds to the output dtype before it adds beta*C, as the
reference's oracle does, where the kernel and the library path add beta*C
in the accumulator.
"""
from __future__ import annotations

from typing import Optional

import torch


def ref_gemm(a, b, c=None, alpha=1.0, beta=0.0, trans_a: bool = False,
             trans_b: bool = False):
    """C = alpha * op(A) @ op(B) + beta * C, computed by torch."""
    opa = a.T if trans_a else a
    opb = b.T if trans_b else b
    if opa.is_complex():
        out = alpha * (opa @ opb)
    else:
        acc = torch.float64 if opa.dtype == torch.float64 else torch.float32
        out = alpha * torch.matmul(opa.to(acc), opb.to(acc))
        out = out.to(torch.promote_types(a.dtype, b.dtype))
    if c is not None:
        out = out + beta * c
    return out


def ref_grouped_gemm(x, w, group_sizes):
    """Per-group x[g_rows] @ w[g]: x (T, K), w (G, K, N), sizes (G,).

    Rows of x are laid out group-contiguously (sum(sizes) == T)."""
    G = w.shape[0]
    sizes = group_sizes.long()
    starts = torch.cumsum(sizes, 0) - sizes
    T = x.shape[0]
    row = torch.arange(T, device=x.device)[:, None]
    out = torch.zeros((T, w.shape[-1]),
                      dtype=torch.promote_types(x.dtype, w.dtype),
                      device=x.device)
    for g in range(G):
        sel = (row >= starts[g]) & (row < starts[g] + sizes[g])
        xg = torch.where(sel, x, 0)
        out = out + torch.where(sel, xg @ w[g], 0)
    return out


def ref_rmsnorm(x, w, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def f32_einsum(eq: str, a, b):
    """einsum with f32 accumulation and an f32 result (the reference's
    ``preferred_element_type=jnp.float32``): operands are widened first,
    so every product is exact."""
    return torch.einsum(eq, a.float(), b.float())


# --------------------------------------------------------------------------
# Attention.
# --------------------------------------------------------------------------

def _mask_bias(sq: int, sk: int, q_offset: int, causal: bool,
               window: Optional[int], dtype, device=None):
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= ki <= qi
    if window is not None:
        ok &= ki > qi - window
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(ok, zero, torch.tensor(float("-inf"), dtype=dtype,
                                              device=device))


def ref_mha(q, k, v, *, causal: bool = True, window: Optional[int] = None,
            q_offset: int = 0, scale: Optional[float] = None):
    """Quadratic reference attention. q: (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D).

    GQA: Hq must be a multiple of Hkv; kv heads are broadcast."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    rep = Hq // Hkv
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)
    scale = scale if scale is not None else D ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    logits = logits + _mask_bias(Sq, k.shape[2], q_offset, causal, window,
                                 torch.float32, q.device)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def chunked_mha(q, k, v, *, causal: bool = True,
                window: Optional[int] = None, q_offset: int = 0,
                scale: Optional[float] = None, kv_chunk: int = 1024):
    """Online-softmax attention scanning KV in chunks of ``kv_chunk``, in
    plain torch ops: the library path of ``models/layers.py::_full_attn``
    (the reference's ``lax.scan`` becomes a Python loop; memory O(S·c)).
    The ``-inf`` masking and the ``isfinite`` guards of fully masked rows
    are the reference's, step for step."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    nc = -(Sk // -kv_chunk)
    pad = nc * kv_chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    qf = q.float()
    qi = torch.arange(Sq, device=dev)[:, None] + q_offset
    neg = torch.tensor(float("-inf"), device=dev)
    zero = torch.zeros((), device=dev)
    from repro_torch.parallel.ctx import constrain
    m = constrain(torch.full((B, Hq, Sq), float("-inf"), device=dev),
                  "batch", "heads", None)
    l = constrain(torch.zeros((B, Hq, Sq), device=dev),
                  "batch", "heads", None)
    acc = constrain(torch.zeros((B, Hq, Sq, D), device=dev),
                    "batch", "heads", None, None)
    for ci in range(nc):
        sl = slice(ci * kv_chunk, (ci + 1) * kv_chunk)
        kb = torch.repeat_interleave(k[:, :, sl], rep, dim=1)
        vb = torch.repeat_interleave(v[:, :, sl], rep, dim=1)
        # einsum in f32 on widened operands: the reference's
        # preferred_element_type=f32 (every product exact)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb.float()) * scale
        ki = ci * kv_chunk + torch.arange(kv_chunk, device=dev)[None, :]
        ok = ki < Sk
        if causal:
            ok = ok & (ki <= qi)
        if window is not None:
            ok = ok & (ki > qi - window)
        s = torch.where(ok[None, None], s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        # guard fully-masked rows (m_new == -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(ok[None, None], p, zero)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), zero)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-37)[..., None]
    return out.to(q.dtype)


# --------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality).
# --------------------------------------------------------------------------

def ref_ssd_recurrent(x, dt, A, B, C, *, D_skip=None):
    """Ground-truth sequential recurrence (one step per token).

    x: (Bt, S, H, P); dt: (Bt, S, H); A: (H,) (negative);
    B, C: (Bt, S, G, N) with G == 1 broadcast over heads.
    h_t = exp(dt*A) h_{t-1} + dt * B_t x_t ;  y_t = C_t . h_t
    """
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf = B.float()[:, :, 0], C.float()[:, :, 0]     # (Bt, S, N)
    h = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        da = torch.exp(dtf[:, t] * A[None, :])              # (Bt, H)
        inp = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]
               * Bf[:, t, None, None, :])                   # (Bt,H,P,N)
        h = h * da[..., None, None] + inp
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, 1)                                  # (Bt,S,H,P)
    if D_skip is not None:
        y = y + D_skip[None, None, :, None] * xf
    return y.to(x.dtype)


def ref_ssd(x, dt, A, B, C, *, D_skip=None, chunk: int = 64,
            return_state: bool = False):
    """Chunked SSD (arXiv:2405.21060 §6): intra-chunk 'attention-like'
    term + inter-chunk state recurrence, one chunk per loop step.

    Mathematically identical to :func:`ref_ssd_recurrent`; the model's
    library path.  The loop keeps the working set at one chunk: the
    vectorised form would materialise a (Bt, nc, c, c, H) decay tensor.
    """
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    nc = -(S // -chunk)
    pad = nc * chunk - S
    xf, dtf = x.float(), dt.float()
    Bf, Cf = B.float()[:, :, 0], C.float()[:, :, 0]     # (Bt, S, N)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = torch.nn.functional.pad(dtf, (0, 0, 0, pad))
        Bf = torch.nn.functional.pad(Bf, (0, 0, 0, pad))
        Cf = torch.nn.functional.pad(Cf, (0, 0, 0, pad))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    neg = torch.tensor(float("-inf"), device=x.device)
    from repro_torch.parallel.ctx import constrain
    h = constrain(torch.zeros((Bt, H, P, N), dtype=torch.float32,
                              device=x.device),
                  "batch", "ssm_heads", None, None)
    ys = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        xc, dtc, Bc, Cc = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl]
        dA = dtc * A[None, None, :]                         # (Bt, c, H)
        cum = torch.cumsum(dA, dim=1)                       # inclusive
        tot = cum[:, -1]                                    # (Bt, H)
        decay = cum[:, :, None, :] - cum[:, None, :, :]     # (Bt,t,s,H)
        # masked before the exp: above the diagonal the decay is a sum of
        # -dt * A > 0 that overflows exp at a full chunk, and inf times
        # the masked zero gradient is NaN in the backward (the
        # reference's order, exp then mask, has that fault; the forward
        # is the same bits either way)
        L = torch.exp(torch.where(tri[None, :, :, None], decay, neg))
        cb = torch.einsum("btn,bsn->bts", Cc, Bc)
        scores = cb[..., None] * L * dtc[:, None]           # (Bt,t,s,H)
        y = torch.einsum("btsh,bshp->bthp", scores, xc)
        y = y + torch.einsum("btn,bhpn->bthp", Cc, h) \
            * torch.exp(cum)[..., None]
        w = (dtc * torch.exp(tot[:, None] - cum))[..., None] * xc
        h = h * torch.exp(tot)[..., None, None] \
            + torch.einsum("bchp,bcn->bhpn", w, Bc)
        ys.append(y)
    y = torch.cat(ys, 1)[:, :S]
    if D_skip is not None:
        y = y + D_skip[None, None, :, None] * x.float()
    y = y.to(x.dtype)
    if return_state:
        return y, h
    return y


def ref_ssd_decode_step(h, x_t, dt_t, A, B_t, C_t):
    """One-token SSM recurrence for serving (state in, state out).

    h: (Bt,H,P,N); x_t: (Bt,H,P); dt_t: (Bt,H); B_t/C_t: (Bt,N)."""
    da = torch.exp(dt_t * A[None, :])
    h = h * da[..., None, None] + (dt_t[..., None, None]
                                   * x_t[..., None] * B_t[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h, C_t)
    return h, y
