"""The generated IAAT GEMM kernel family, on Hopper.

Counterpart of ``repro/kernels/iaat_gemm.py``: :func:`gemm_region` runs
one plan region, ``alpha * op(A) @ op(B) + beta * C``, with the kernel of
one :class:`KernelSig`.

* On a CUDA tensor it launches the hand-written CUDA kernel or raises;
  there is no fallback: ``csrc/iaat_gemm.cu`` for S/D/H,
  ``csrc/cx_gemm.cu`` (the 3-mult Karatsuba) for C/Z, both built by
  ``kernels/build.py``.  Each launch is checked with ``cudaGetLastError``
  and counted (:func:`launch_count`, per kernel).
* On a CPU tensor it runs :func:`gemm_region_plain`, the plain PyTorch
  version (f32/f64 accumulation, one cast; for C/Z the same Karatsuba
  planes and complex epilogue as the kernel): the tests' reference, and
  on the card only the comparison in ``chip_smoke.py``.

Operands are passed as strided views: op(A) and op(B) are ``.T`` views for
the transposed cases, so the four transpositions, the tied ``embed.T`` and
the region views of ``plan.execute`` all reach the kernel without a copy.
A complex operand is read in place through its complex strides (no split
into real and imaginary planes, the TPU kernel's pack copy).

alpha/beta are run-time arguments of the CUDA kernels (the TPU kernels
baked them in per build); an instance is specialised on (dtype, bm, bn,
bk) only.  Real regions are differentiable; complex regions are
forward-only, as in the reference, and raise when autograd would record
them.

D on this card: Hopper has an f64 datapath (67 TFLOP/s on its tensor
cores, 34 on CUDA cores), so DGEMM runs through the same kernel with an
f64 accumulator, on the card, rather than in the TPU package's
interpret-only mode (DESIGN_PORT.md §5); Z likewise, on f64 planes.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import templates
from repro_torch.core.kernelgen import KernelSig

_launches = {"iaat_gemm": 0, "cx_gemm": 0}


def launch_count(kernel: Optional[str] = None) -> int:
    """CUDA launches since the last :func:`reset_launch_count`: of
    ``kernel`` ("iaat_gemm", the real kernel, or "cx_gemm", the complex
    one), or of both when ``kernel`` is None."""
    if kernel is None:
        return sum(_launches.values())
    return _launches[kernel]


def reset_launch_count() -> None:
    for k in _launches:
        _launches[k] = 0


def records_grad(*ts: Optional[torch.Tensor]) -> bool:
    """Whether autograd would record a call on these operands."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


# --------------------------------------------------------------------------
# The plain version.
# --------------------------------------------------------------------------

def gemm_region_plain(sig: KernelSig, a, b, c=None, alpha=1.0, beta=0.0):
    """Plain PyTorch version of one region: op(a) @ op(b) in the
    accumulator dtype (f32 for S/H, f64 for D), alpha/beta epilogue in the
    accumulator dtype, one cast to result_type(a, b).  A complex ``sig``
    takes :func:`cx_region_plain`."""
    if sig.complex_:
        return cx_region_plain(sig, a, b, c, alpha, beta)
    acc = templates.contract(a, b, sig.trans, sig.acc_dtype)
    return templates.epilogue_axpby(acc, c, alpha, beta,
                                    torch.promote_types(a.dtype, b.dtype))


def cx_region_plain(sig: KernelSig, a, b, c=None, alpha=1.0, beta=0.0):
    """Plain PyTorch version of one complex region, rounding as the CUDA
    kernel and the reference's ``_cx_body`` do: the real and imaginary
    planes (``.real``/``.imag`` views), the three Karatsuba contractions
    in the plane type (``templates.cmul_karatsuba``: Ar+Ai and Br+Bi
    formed in the plane type), one combine, then the complex alpha/beta
    epilogue in the plane type."""
    acc = sig.acc_dtype
    p1, p2, p3 = templates.cmul_karatsuba(a.real, a.imag, b.real, b.imag,
                                          sig.trans, acc)
    cr, ci = templates.karatsuba_combine(p1, p2, p3)
    alpha, beta = complex(alpha), complex(beta)
    outr = alpha.real * cr - alpha.imag * ci
    outi = alpha.real * ci + alpha.imag * cr
    if c is not None:
        co_r, co_i = c.real.to(acc), c.imag.to(acc)
        outr = outr + (beta.real * co_r - beta.imag * co_i)
        outi = outi + (beta.real * co_i + beta.imag * co_r)
    return torch.complex(outr, outi).to(sig.dtype)


# --------------------------------------------------------------------------
# The kernel launch.
# --------------------------------------------------------------------------

def _launch(sig: KernelSig, a, b, c, alpha, beta, out):
    from repro_torch.kernels import build
    opa = templates.op(a, sig.trans[0])
    opb = templates.op(b, sig.trans[1])
    M, K = opa.shape
    K2, N = opb.shape
    if K != K2:
        raise ValueError(f"K mismatch: op(A) {tuple(opa.shape)} vs op(B) "
                         f"{tuple(opb.shape)}")
    if min(M, N, K) < 1:
        raise ValueError(f"empty GEMM {M}x{N}x{K}")
    dev = a.device
    for name, t in (("b", b), ("c", c), ("out", out)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, a on {dev}")
    for name, t in (("a", a), ("b", b), ("c", c), ("out", out)):
        if t is not None and t.dtype != sig.dtype:
            raise TypeError(f"{sig.name}: {name} is {t.dtype}, the kernel "
                            f"takes {sig.dtype}")
    if c is not None and tuple(c.shape) != (M, N):
        raise ValueError(f"c {tuple(c.shape)} != ({M}, {N})")
    if out is None:
        out = torch.empty((M, N), dtype=sig.dtype, device=dev)
    elif tuple(out.shape) != (M, N):
        raise ValueError(f"out {tuple(out.shape)} != ({M}, {N})")
    if sig.complex_:
        # complex strides in complex elements: the kernel reads each
        # (re, im) pair in place; a lazily conjugated view is resolved
        # first (its memory holds the unconjugated values)
        opa, opb = opa.resolve_conj(), opb.resolve_conj()
        c = None if c is None else c.resolve_conj()
        kernel = "cx_gemm"
        scalars = (complex(alpha).real, complex(alpha).imag,
                   complex(beta).real, complex(beta).imag)
    else:
        kernel = "iaat_gemm"
        scalars = (float(alpha), float(beta))
    fn = getattr(build.load(), f"{kernel}_{sig.letter}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(sig.bm, sig.bn, sig.bk,
                opa.data_ptr(), opa.stride(0), opa.stride(1),
                opb.data_ptr(), opb.stride(0), opb.stride(1),
                None if c is None else c.data_ptr(),
                0 if c is None else c.stride(0),
                0 if c is None else c.stride(1),
                out.data_ptr(), out.stride(0), out.stride(1),
                M, N, K, *scalars, stream)
    if rc == -1:
        raise RuntimeError(f"{sig.name}: no such instance in the built "
                           f"kernel table")
    if rc:
        msg = build.load().iaat_error_string(rc).decode()
        raise RuntimeError(f"{sig.name}: launch failed: {msg}")
    _launches[kernel] += 1
    return out


def _forward(sig: KernelSig, a, b, c, alpha, beta, out=None):
    if a.device.type == "cuda":
        return _launch(sig, a, b, c, alpha, beta, out)
    if a.device.type != "cpu":
        raise ValueError(f"no IAAT kernel for device {a.device}")
    res = gemm_region_plain(sig, a, b, c, alpha, beta)
    if out is None:
        return res
    return out.copy_(res)


# --------------------------------------------------------------------------
# Differentiation: the backward is the two adjoint GEMMs (the BLAS
# adjoint identities), in the accumulator dtype, through torch.matmul —
# the reference evaluates them outside Pallas too.
# --------------------------------------------------------------------------

def _adjoints(sig: KernelSig, a, b, dC, alpha):
    ta, tb = sig.trans[0], sig.trans[1]
    acc = sig.acc_dtype
    opA = templates.op(a, ta).to(acc)
    opB = templates.op(b, tb).to(acc)
    dOpA = alpha * torch.matmul(dC, opB.T)
    dOpB = alpha * torch.matmul(opA.T, dC)
    dA = (dOpA.T if ta == "T" else dOpA).to(a.dtype)
    dB = (dOpB.T if tb == "T" else dOpB).to(b.dtype)
    return dA, dB


class _RegionGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sig, alpha, beta, a, b, c):
        ctx.sig, ctx.alpha, ctx.beta = sig, alpha, beta
        ctx.has_c = c is not None
        ctx.save_for_backward(a, b)
        return _forward(sig, a, b, c, alpha, beta)

    @staticmethod
    def backward(ctx, dC):
        a, b = ctx.saved_tensors
        dCa = dC.to(ctx.sig.acc_dtype)
        dA, dB = _adjoints(ctx.sig, a, b, dCa, ctx.alpha)
        dc = (ctx.beta * dCa).to(dC.dtype) if ctx.has_c else None
        return None, None, None, dA, dB, dc


# --------------------------------------------------------------------------
# Public entry.
# --------------------------------------------------------------------------

def gemm_region(sig: KernelSig, a, b, c=None, *, alpha=1.0, beta=0.0,
                out: Optional[torch.Tensor] = None):
    """Run one plan region: op(a) @ op(b) (+ beta*c) with kernel ``sig``.

    Operand shapes may be any size; the grid is derived with ceil-div and
    edges are bounds-checked in the kernel.  With ``out`` the result is
    written into that (possibly strided) view and returned.  Real dtypes
    are differentiable (then ``out`` is not used: the result is a fresh
    tensor the caller places); complex regions are forward-only (the
    paper's C/Z BLAS entries are not training paths) and raise when
    autograd would record them, on any device."""
    if sig.complex_ and records_grad(a, b, c):
        raise RuntimeError(
            f"{sig.name}: complex IAAT regions are forward-only (no "
            "backward, as in the reference); call under torch.no_grad() "
            "or detach the operands")
    if records_grad(a, b, c):
        return _RegionGemm.apply(sig, float(alpha), float(beta), a, b, c)
    return _forward(sig, a, b, c, alpha, beta, out)
