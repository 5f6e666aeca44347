"""Plain PyTorch oracles (counterparts of ``repro/kernels/ref.py``).

Only the GEMM and RMSNorm oracles are ported so far; the attention and
SSD oracles come with their kernels.  They are the tests' oracles, kept
independent of ``core/templates.py`` on purpose: ``ref_gemm`` rounds to
the output dtype before it adds beta*C, as the reference's oracle does,
where the kernel and the library path add beta*C in the accumulator.
"""
from __future__ import annotations

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


def ref_rmsnorm(x, w, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
