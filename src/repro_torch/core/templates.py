"""Computational Template Designer (paper §IV-A), in PyTorch.

The paper abstracts ARMv8 FMA patterns as templates that the kernel
generator stitches into microkernels.  Here each template is a block
compute pattern on tensors; the plain (CPU) version of the IAAT kernel is
built from them, and the CUDA kernel computes the same patterns:

* ``contract``        — real multiply-accumulate, one template per
                        transposition.  A transposition is a *view* with
                        swapped strides (``.T``), never a ``.contiguous()``
                        copy — the "no pack step" of the paper.
* ``cmul_karatsuba``  — complex multiply-accumulate via 3 real contractions.
* ``cmul_fcmla``      — the literal 4-real-multiplication fcmla pattern.
* ``epilogue_axpby``  — C = alpha*acc + beta*C, beta*C added in the
                        accumulator dtype, then one cast.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# Transposition encoding, matching the paper: op(A)@op(B); "N" = as stored,
# "T" = transposed.  Storage convention (row-major):
#   A: (M, K) if A-trans == "N" else (K, M)
#   B: (K, N) if B-trans == "N" else (N, K)
TRANSPOSITIONS = ("NN", "NT", "TN", "TT")


def op(x: torch.Tensor, t: str) -> torch.Tensor:
    """op(x) as a strided view: ``x.T`` swaps strides and copies nothing."""
    return x.T if t == "T" else x


def contract(a: torch.Tensor, b: torch.Tensor, trans: str,
             acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Real multiply-accumulate template (sfmlas/dfmlas family).

    Returns op(a) @ op(b) accumulated in ``acc_dtype``: the operands are
    widened to it first, so every product is exact and only the sum rounds
    (f32 for S/H, f64 for D)."""
    if trans not in TRANSPOSITIONS:
        raise ValueError(f"bad transposition {trans!r}")
    return torch.matmul(op(a, trans[0]).to(acc_dtype),
                        op(b, trans[1]).to(acc_dtype))


def contract_flops(m: int, n: int, k: int, complex_: bool = False,
                   karatsuba: bool = True) -> int:
    """FLOPs of one block contraction (for the cost model / roofline)."""
    real = 2 * m * n * k
    if not complex_:
        return real
    return (3 if karatsuba else 4) * real + 5 * m * n


def cmul_karatsuba(ar, ai, br, bi, trans: str, acc_dtype=torch.float32):
    """Complex MMA via 3 real contractions (Gauss/Karatsuba).

    P1 = Ar*Br ; P2 = Ai*Bi ; P3 = (Ar+Ai)(Br+Bi)
    Cr = P1 - P2 ; Ci = P3 - P1 - P2"""
    p1 = contract(ar, br, trans, acc_dtype)
    p2 = contract(ai, bi, trans, acc_dtype)
    p3 = contract(ar + ai, br + bi, trans, acc_dtype)
    return p1, p2, p3


def karatsuba_combine(p1, p2, p3) -> Tuple[torch.Tensor, torch.Tensor]:
    return p1 - p2, p3 - p1 - p2


def cmul_fcmla(ar, ai, br, bi, trans: str, acc_dtype=torch.float32):
    """The paper's fcmla pattern: 4 real contractions (naive complex MMA)."""
    cr = contract(ar, br, trans, acc_dtype) - contract(ai, bi, trans, acc_dtype)
    ci = contract(ar, bi, trans, acc_dtype) + contract(ai, br, trans, acc_dtype)
    return cr, ci


def epilogue_axpby(acc, c_old, alpha, beta, out_dtype):
    """C = alpha*acc + beta*C (GEMM epilogue): beta*C is added in the
    accumulator dtype, then the one cast to ``out_dtype``."""
    out = alpha * acc
    if c_old is not None:
        out = out + beta * c_old.to(acc.dtype)
    return out.to(out_dtype)


def negv(x):
    """fneg template (used by the complex combine in the fcmla path)."""
    return -x


@dataclasses.dataclass(frozen=True)
class TemplateInfo:
    """Census entry for the template table."""
    name: str
    arity: int
    description: str


TEMPLATE_TABLE = (
    TemplateInfo("contract.NN", 2, "real MMA, A row-major, B row-major"),
    TemplateInfo("contract.NT", 2, "real MMA, B stored transposed"),
    TemplateInfo("contract.TN", 2, "real MMA, A stored transposed"),
    TemplateInfo("contract.TT", 2, "real MMA, both stored transposed"),
    TemplateInfo("cmul_karatsuba", 4, "complex MMA, 3 real contractions"),
    TemplateInfo("cmul_fcmla", 4, "complex MMA, 4 real contractions (paper)"),
    TemplateInfo("epilogue_axpby", 2, "alpha/beta epilogue"),
    TemplateInfo("negv", 1, "negation (fneg)"),
)
