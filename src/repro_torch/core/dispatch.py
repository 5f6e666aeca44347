"""The paper's *traditional* (pack-step) GEMM baseline (port).

Counterpart of ``repro/core/dispatch.py``.  The routing lives in
:mod:`repro_torch.api`; what remains here is the explicit pack-step
pipeline of the paper's §I — transpose-normalise and zero-pad both
operands into fresh buffers (the pack copy), then run ONE fixed kernel
over the padded problem — kept as the baseline of the Fig. 3 pack-cost
question.  It is deliberately NOT routed: it measures what IAAT removes.

The fixed kernel per letter (:data:`PACK_SIG`) is the Hopper table's
block of the largest area, at the deeper bk (DESIGN_PORT.md §9): the
fewest blocks over a padded problem, as the reference's TPU blocks were.
"""
from __future__ import annotations

import torch

from repro_torch.core import kernelgen, templates, vmem

#: (bm, bn, bk) of the one fixed kernel per letter, an instance of
#: ``kernelgen.kernel_table(letter, "NN")``
PACK_SIG = {"S": (128, 128, 64), "D": (64, 128, 64),
            "C": (64, 64, 64), "Z": (32, 64, 64),
            "H": (128, 128, 64)}


def _pad_copy(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The pack step: a zeroed (rows x cols) buffer with ``x`` copied into
    its corner (a real copy, whatever ``x``'s strides)."""
    buf = torch.zeros((rows, cols), dtype=x.dtype, device=x.device)
    buf[:x.shape[0], :x.shape[1]] = x
    return buf


def traditional_gemm(a, b, c=None, alpha=1.0, beta=0.0,
                     trans_a: bool = False, trans_b: bool = False):
    """Classic block+pack+compute GEMM (paper §I): normalise both operands
    into padded NN layout (the pack step, real extra memory traffic), then
    run ONE fixed kernel over the padded problem; beta*C is added after,
    in the output dtype, as in the reference.  On a CUDA tensor the fixed
    kernel is the CUDA kernel of the letter; on the CPU its plain
    version."""
    from repro_torch import api
    from repro_torch.kernels import iaat_gemm
    trans = api._trans_str(trans_a, trans_b)
    M, N, K = api._problem_dims(a.shape, b.shape, trans)
    letter = kernelgen.blas_letter(torch.promote_types(a.dtype, b.dtype))
    bm, bn, bk = PACK_SIG[letter]
    Mp, Np, Kp = (vmem.round_up(M, bm), vmem.round_up(N, bn),
                  vmem.round_up(K, bk))
    opa = _pad_copy(templates.op(a, trans[0]), Mp, Kp)
    opb = _pad_copy(templates.op(b, trans[1]), Kp, Np)
    sig = kernelgen.KernelSig(letter, "NN", bm, bn, bk)
    out = iaat_gemm.gemm_region(sig, opa, opb, None, alpha=alpha,
                                beta=0.0)[:M, :N]
    if c is not None:
        out = out + beta * c.to(out.dtype)
    return out


def traditional_pack_bytes(M: int, N: int, K: int, dtype) -> int:
    """Device-memory bytes the pack step moves: each padded panel written
    once and read once by the kernel."""
    item = vmem.itemsize(dtype)
    bm, bn, bk = PACK_SIG[kernelgen.blas_letter(dtype)]
    Mp, Np, Kp = (vmem.round_up(M, bm), vmem.round_up(N, bn),
                  vmem.round_up(K, bk))
    return 2 * (Mp * Kp + Kp * Np) * item
