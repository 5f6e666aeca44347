"""The generated IAAT GEMM kernel family, on Hopper.

Counterpart of ``repro/kernels/iaat_gemm.py``: :func:`gemm_region` runs
one plan region, ``alpha * op(A) @ op(B) + beta * C``, with the kernel of
one :class:`KernelSig`.

* On a CUDA tensor it launches the hand-written CUDA kernel or raises;
  there is no fallback: ``csrc/iaat_gemm.cu`` for S/D/H,
  ``csrc/cx_gemm.cu`` (the 3-mult Karatsuba) for C/Z, both built by
  ``kernels/build.py``.  Each launch is checked with ``cudaGetLastError``
  and counted (:func:`launch_count`, per kernel; :func:`path_count`, per
  path of the real kernel: the cp.async ring or the scalar loads, and
  split-K launches).  A complex plan is one launch (:func:`cx_plan`,
  over the plan's region table), a complex region alone too.  A real
  region may be cut into K slices (the plan's
  ``Region.slices``): one launch still, its blocks summing into a
  ``torch.empty`` workspace, the last block of each output tile adding
  the slices in order (per-tile tickets, one zeroed array per device and
  stream: split launches on two streams, the engine's and the online
  tuner's, never share a ticket).
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

import functools
from typing import Optional

import torch

from repro_torch.core import kernelgen, templates
from repro_torch.core.kernelgen import KernelSig
from repro_torch.kernels import build

_launches = {"iaat_gemm": 0, "cx_gemm": 0}
#: launches of the real kernel by path: "ring" (16-byte cp.async copies),
#: "scalar" (synchronous element loads), and "split" (slices > 1, either
#: path)
_paths = {"ring": 0, "scalar": 0, "split": 0}
#: the real kernel's C entry (``iaat_gemm_<path>_<letter>``) and the path
#: it counts under, per load mode
_MODES = {0: ("scalar", "scalar"), 1: ("ring_n", "ring"),
          2: ("ring_k", "ring")}
#: one zeroed ticket per output tile of a split launch, per (device,
#: stream); a split grid underfills the card, so it has fewer tiles than
#: this.  The tickets reset themselves at the end of each launch, so
#: only launches on one stream, which run in order, may share them.
_TICKETS_LEN = 1024
_tickets = {}


def launch_count(kernel: Optional[str] = None) -> int:
    """CUDA launches since the last :func:`reset_launch_count`: of
    ``kernel`` ("iaat_gemm", the real kernel, or "cx_gemm", the complex
    one), or of both when ``kernel`` is None."""
    if kernel is None:
        return sum(_launches.values())
    return _launches[kernel]


def reset_launch_count() -> None:
    for d in (_launches, _paths):
        for k in d:
            d[k] = 0


def path_count(path: str) -> int:
    """Real-kernel launches since the last :func:`reset_launch_count` on
    ``path``: "ring", "scalar" or "split"."""
    return _paths[path]


def _row_aligned(t: torch.Tensor, unit: int) -> bool:
    """Whether ``t`` (2-D) has unit stride along dim ``unit`` and
    16-byte-aligned rows along the other dim, so that 16-byte copies
    along ``unit`` are aligned."""
    return (t.stride(unit) == 1 and t.data_ptr() % 16 == 0 and
            (t.stride(1 - unit) * t.element_size()) % 16 == 0)


def load_mode(opa: torch.Tensor, opb: torch.Tensor) -> int:
    """The real kernel's path for op(A) (M x K) and op(B) (K x N), by
    their strides: 1 (the ring, B read along N) or 2 (the ring, B read
    along K) when A has k of unit stride and both have 16-byte-aligned
    rows; else 0 (the scalar path)."""
    if not _row_aligned(opa, 1):
        return 0
    if _row_aligned(opb, 1):
        return 1
    if _row_aligned(opb, 0):
        return 2
    return 0


def _tickets_on(dev: torch.device, stream: int) -> torch.Tensor:
    """The ticket array of split launches on ``stream`` (a raw stream
    handle) of ``dev``, zeroed on first use on that stream."""
    key = (dev, stream)
    t = _tickets.get(key)
    if t is None:
        t = _tickets[key] = torch.zeros(_TICKETS_LEN, dtype=torch.int32,
                                        device=dev)
    return t


def c_dtype(sig: KernelSig) -> torch.dtype:
    """The dtype ``c`` reaches a region in: the accumulator's for S/D/H
    (so an f32 ``c`` of an H GEMM is never rounded through bf16), the
    complex type for C/Z.  :func:`gemm_region` casts any other ``c`` to
    it; the CUDA kernels read ``c`` in it."""
    return sig.dtype if sig.complex_ else sig.acc_dtype


def records_grad(*ts: Optional[torch.Tensor]) -> bool:
    """Whether autograd would record a call on these operands."""
    if not torch.is_grad_enabled():
        return False
    for t in ts:
        if t is not None and t.requires_grad:
            return True
    return False


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

@functools.lru_cache(maxsize=None)
def _sig_types(sig: KernelSig):
    """(dtype of a, b and out, dtype of c) of a signature's launch."""
    return sig.dtype, c_dtype(sig)


@functools.lru_cache(maxsize=None)
def _entry(sig: KernelSig, mode: int):
    """The real kernel's C entry of a signature for load path ``mode``."""
    return getattr(build.load(), f"iaat_gemm_{_MODES[mode][0]}_{sig.letter}")


@functools.lru_cache(maxsize=None)
def _cx_entry(letter: str):
    """The complex kernel's C entry of a letter (C or Z)."""
    return getattr(build.load(), f"cx_gemm_{letter}")


def _launch(sig: KernelSig, a, b, c, alpha, beta, out, slices=1):
    if sig.complex_:
        if slices != 1:
            raise ValueError(f"{sig.name}: the complex kernel takes no K "
                             "slices")
        return _launch_cx(sig.letter, sig.trans,
                          _region_tables(sig, *_mn(a, b, sig.trans)), a, b,
                          c, alpha, beta, out)
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
    idx = a.get_device()
    dt, dt_c = _sig_types(sig)
    for name, t, want in (("a", a, dt), ("b", b, dt), ("c", c, dt_c),
                          ("out", out, dt)):
        if t is None:
            continue
        if t.get_device() != idx:
            raise ValueError(f"{name} on {t.device}, a on {dev}")
        if t.dtype != want:
            raise TypeError(f"{sig.name}: {name} is {t.dtype}, the kernel "
                            f"takes {want}")
    if c is not None and c.shape != (M, N):
        raise ValueError(f"c {tuple(c.shape)} != ({M}, {N})")
    if out is None:
        out = torch.empty((M, N), dtype=dt, device=dev)
    elif out.shape != (M, N):
        raise ValueError(f"out {tuple(out.shape)} != ({M}, {N})")
    if slices < 1:
        raise ValueError(f"{sig.name}: {slices} K slices")
    mode = load_mode(opa, opb)
    # the launch goes to a's current stream (the raw handle: a Stream
    # object a call costs host time at decode)
    stream = torch._C._cuda_getCurrentRawStream(idx)
    ws = None
    if slices > 1:
        tiles = -(-M // sig.bm) * -(-N // sig.bn)
        if tiles > _TICKETS_LEN:
            raise ValueError(f"{sig.name}: a split grid of {tiles} "
                             f"tiles exceeds the {_TICKETS_LEN} tickets")
        tickets = _tickets_on(dev, stream)
        # held until the launch is queued; the stream orders any reuse
        ws = torch.empty((slices, M, N), dtype=sig.acc_dtype, device=dev)
    tail = (float(alpha), float(beta), slices,
            None if ws is None else ws.data_ptr(),
            None if ws is None else tickets.data_ptr())
    sa, sb = opa.stride(), opb.stride()
    so = out.stride()
    sc = (0, 0) if c is None else c.stride()
    args = (sig.bm, sig.bn, sig.bk, opa.data_ptr(), sa[0], sa[1],
            opb.data_ptr(), sb[0], sb[1],
            None if c is None else c.data_ptr(), sc[0], sc[1],
            out.data_ptr(), so[0], so[1], M, N, K, *tail)
    fn = _entry(sig, mode)
    if idx == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    if rc == -1:
        raise RuntimeError(f"{sig.name}: no such instance in the built "
                           f"kernel table")
    if rc:
        msg = build.load().iaat_error_string(rc).decode()
        raise RuntimeError(f"{sig.name}: launch failed: {msg}")
    _launches["iaat_gemm"] += 1
    _paths[_MODES[mode][1]] += 1
    _paths["split"] += slices > 1
    return out


# --------------------------------------------------------------------------
# The complex kernel: one launch a plan (or a region alone).
# --------------------------------------------------------------------------

def _mn(a, b, trans):
    """(M, N) of op(a) @ op(b)."""
    return (a.shape[1] if trans[0] == "T" else a.shape[0],
            b.shape[0] if trans[1] == "T" else b.shape[1])


@functools.lru_cache(maxsize=4096)
def _region_tables(sig: KernelSig, M: int, N: int):
    """The C launch table of one region, ``sig``'s blocks over (M, N)."""
    from repro_torch.core import plan as plan_mod
    gm, gn = -(-M // sig.bm), -(-N // sig.bn)
    return plan_mod.c_tables(plan_mod.launch_tables(
        M, N, (plan_mod.Region(sig, 0, 0, gm, gn, 1),)))


def _launch_cx(letter: str, trans: str, tables, a, b, c, alpha, beta,
               out=None):
    """Launch the complex kernel of ``letter`` once per region table of
    ``tables`` (``Plan.c_launch_tables``).  ``a``, ``b`` and ``out`` are
    in the letter's complex dtype, ``c`` too or None."""
    opa = templates.op(a, trans[0])
    opb = templates.op(b, trans[1])
    M, K = opa.shape
    K2, N = opb.shape
    if K != K2:
        raise ValueError(f"K mismatch: op(A) {tuple(opa.shape)} vs op(B) "
                         f"{tuple(opb.shape)}")
    if min(M, N, K) < 1:
        raise ValueError(f"empty GEMM {M}x{N}x{K}")
    dt = kernelgen.BLAS_DTYPES[letter]
    dev = a.device
    idx = a.get_device()
    for name, t in (("a", a), ("b", b), ("c", c), ("out", out)):
        if t is None:
            continue
        if t.get_device() != idx:
            raise ValueError(f"{name} on {t.device}, a on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{letter} GEMM: {name} is {t.dtype}, the "
                            f"kernel takes {dt}")
    if c is not None and c.shape != (M, N):
        raise ValueError(f"c {tuple(c.shape)} != ({M}, {N})")
    if out is None:
        out = torch.empty((M, N), dtype=dt, device=dev)
    elif out.shape != (M, N):
        raise ValueError(f"out {tuple(out.shape)} != ({M}, {N})")
    # complex strides in complex elements: the kernel reads each (re, im)
    # pair in place; a lazily conjugated view is resolved first (its
    # memory holds the unconjugated values)
    if opa.is_conj():
        opa = opa.resolve_conj()
    if opb.is_conj():
        opb = opb.resolve_conj()
    if c is not None and c.is_conj():
        c = c.resolve_conj()
    pa, pb, po = opa.data_ptr(), opb.data_ptr(), out.data_ptr()
    pc = None if c is None else c.data_ptr()
    # each element is one cp.async of its own size
    if (pa | pb | po | (pc or 0)) % out.element_size():
        raise ValueError(f"{letter} GEMM: an operand is not aligned to its "
                         f"{out.element_size()}-byte elements")
    sa, sb, so = opa.stride(), opb.stride(), out.stride()
    sc = (0, 0) if c is None else c.stride()
    alpha, beta = complex(alpha), complex(beta)
    args = (pa, sa[0], sa[1], pb, sb[0], sb[1], pc, sc[0], sc[1], po,
            so[0], so[1], K, alpha.real, alpha.imag, beta.real, beta.imag)
    fn = _cx_entry(letter)
    stream = torch._C._cuda_getCurrentRawStream(idx)
    for tab, n in tables:
        # the launch goes to the current device, as the real kernel's
        if idx == torch.cuda.current_device():
            rc = fn(tab, n, *args, stream)
        else:
            with torch.cuda.device(dev):
                rc = fn(tab, n, *args, stream)
        if rc == -1:
            raise RuntimeError(f"{letter} GEMM: a region's block is no "
                               "instance of the built kernel table")
        if rc:
            msg = build.load().iaat_error_string(rc).decode()
            raise RuntimeError(f"{letter} GEMM: launch failed: {msg}")
        _launches["cx_gemm"] += 1
    return out


def cx_plan(plan, a, b, c=None, alpha=1.0, beta=0.0) -> torch.Tensor:
    """Run a complex plan (``core/plan.py``): ``a`` and ``b`` in the
    plan's complex dtype, ``c`` of any dtype.  On a CUDA tensor one launch
    of the complex kernel per region table of ``plan.launch_tables`` (one
    for a plan of at most ``plan.LAUNCH_REGIONS`` regions); on a CPU
    tensor each table row's region by :func:`cx_region_plain`, written at
    its offsets.  Forward-only, as :func:`gemm_region`."""
    dt = kernelgen.BLAS_DTYPES[plan.letter]
    if c is not None and c.dtype != dt:
        c = c.to(dt)
    if records_grad(a, b, c):
        raise RuntimeError(
            f"{plan.letter} GEMM: complex IAAT regions are forward-only (no "
            "backward, as in the reference); call under torch.no_grad() or "
            "detach the operands")
    if a.device.type == "cuda":
        return _launch_cx(plan.letter, plan.trans, plan.c_launch_tables, a,
                          b, c, alpha, beta)
    if a.device.type != "cpu":
        raise ValueError(f"no IAAT kernel for device {a.device}")
    out = torch.empty((plan.M, plan.N), dtype=dt, device=a.device)
    a_m = 0 if plan.trans[0] == "N" else 1
    b_n = 1 if plan.trans[1] == "N" else 0
    for table in plan.launch_tables:
        for _, m0, m_hi, n0, n_hi, _, bm, bn, bk in table:
            sig = KernelSig(plan.letter, plan.trans, bm, bn, bk)
            out[m0:m_hi, n0:n_hi] = cx_region_plain(
                sig, a.narrow(a_m, m0, m_hi - m0),
                b.narrow(b_n, n0, n_hi - n0),
                None if c is None else c[m0:m_hi, n0:n_hi], alpha, beta)
    return out


def _forward(sig: KernelSig, a, b, c, alpha, beta, out=None, slices=1):
    if a.device.type == "cuda":
        return _launch(sig, a, b, c, alpha, beta, out, slices)
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
    def forward(ctx, sig, alpha, beta, slices, a, b, c):
        ctx.sig, ctx.alpha, ctx.beta = sig, alpha, beta
        ctx.has_c = c is not None
        ctx.save_for_backward(a, b)
        return _forward(sig, a, b, c, alpha, beta, slices=slices)

    @staticmethod
    def backward(ctx, dC):
        a, b = ctx.saved_tensors
        dCa = dC.to(ctx.sig.acc_dtype)
        dA, dB = _adjoints(ctx.sig, a, b, dCa, ctx.alpha)
        dc = (ctx.beta * dCa).to(dC.dtype) if ctx.has_c else None
        return None, None, None, None, dA, dB, dc


# --------------------------------------------------------------------------
# Public entry.
# --------------------------------------------------------------------------

def gemm_region(sig: KernelSig, a, b, c=None, *, alpha=1.0, beta=0.0,
                out: Optional[torch.Tensor] = None, slices: int = 1):
    """Run one plan region: op(a) @ op(b) (+ beta*c) with kernel ``sig``.

    Operand shapes may be any size; the grid is derived with ceil-div and
    edges are bounds-checked in the kernel.  With ``out`` the result is
    written into that (possibly strided) view and returned.  Real dtypes
    are differentiable (then ``out`` is not used: the result is a fresh
    tensor the caller places); complex regions are forward-only (the
    paper's C/Z BLAS entries are not training paths) and raise when
    autograd would record them, on any device.  ``a`` and ``b`` are in
    ``sig.dtype`` (``plan.execute`` promotes them); a ``c`` of any dtype
    enters in :func:`c_dtype` and the result is in ``sig.dtype``.
    ``slices`` cuts K for the real kernel (``plan.k_slices``; the plain
    version on the CPU computes the same sum and ignores it)."""
    if c is not None:
        c = c.to(_sig_types(sig)[1])
    grad = records_grad(a, b, c)
    if grad and sig.complex_:
        raise RuntimeError(
            f"{sig.name}: complex IAAT regions are forward-only (no "
            "backward, as in the reference); call under torch.no_grad() "
            "or detach the operands")
    if grad:
        return _RegionGemm.apply(sig, float(alpha), float(beta), slices, a,
                                 b, c)
    return _forward(sig, a, b, c, alpha, beta, out, slices)
