"""Candidate search: analytical prior first, stopwatch second (port).

Counterpart of ``repro/tune/search.py``.  Per size class the search (a)
enumerates every kernel of the install-time table, (b) ranks them with
the roofline prior — padded-grid operations vs streamed bytes, the
physics of ``core/cost.py`` — and (c) times only the ``top`` ranked
candidates plus the library.  The prior never decides, it only prunes.

* The kernel side is ``iaat_gemm.gemm_region(sig, a, b)``: one region of
  ``sig`` blocks over the whole problem, which is the plan a profile's
  winner later pins (``plan._override_plan``).  On the card that is the
  CUDA kernel (real or complex Karatsuba); on the CPU its plain version.
* The library side is ``api._lib_gemm``'s arithmetic: ``torch.matmul``
  in the accumulator dtype, with TF32 off (:func:`sweep` turns it off, as
  ``api.install`` does).
* Grouped classes time ``batched_gemm`` with each candidate's blocks
  against the executor's library einsum.
* A class is timed at its representative with the stored operands' row
  lengths rounded to the letter's 16-byte grain (:func:`timed_shape`):
  the kernels take their cp.async ring only for 16-byte-aligned rows, and
  a served model's shapes are aligned, so an odd representative (11,
  5793, 11585) would time the scalar path that the class's traffic does
  not take.  The entry records the path that was timed
  (``ProfileEntry.path``).  The buckets stay the reference's.
* Operands are normal values from a generator seeded with :data:`SEED`:
  on the CPU drawn on the host in f64, so a CPU sweep is deterministic;
  on the card drawn there, in the letter's plane type, from a
  ``torch.Generator`` on the card, so a class's operands (up to some
  34 M values) cost no host time beside a serving engine.

A sweep makes its operands, launches and times on the caller's current
CUDA stream and never synchronises the device, so
:class:`repro_torch.tune.online.OnlineTuner`, which enters its own stream
around :func:`budgeted_sweep`, leaves the serving stream alone.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core import cost, kernelgen, vmem
from repro_torch.core import plan as plan_mod
from repro_torch.core.kernelgen import KernelSig
from repro_torch.tune import classes as classes_mod
from repro_torch.tune.classes import SizeClass
from repro_torch.tune.profile import (DeviceProfile, ProfileEntry,
                                      device_kind_of)
from repro_torch.tune.timer import Measurement, try_measure

#: the seed of every sweep's operands (the reference's 0x1AA7)
SEED = 0x1AA7


def _cdiv(a: int, b: int) -> int:
    return -(a // -b)


def prior_us(sig: KernelSig, M: int, N: int, K: int) -> float:
    """Roofline estimate (µs) of running the whole problem on one kernel.

    Operations count the *padded* grid (an oversized block computes
    masked rows and columns); traffic counts each block's A and B panels
    per K step plus C's write-out.  The kernels run on CUDA cores (f32
    FMAs for S/H/C, f64 for D/Z, at half the rate).  Only the ordering is
    used, and only to prune."""
    gm, gn, nk = _cdiv(M, sig.bm), _cdiv(N, sig.bn), _cdiv(K, sig.bk)
    item = vmem.itemsize(sig.real_dtype)
    planes = 2 if sig.complex_ else 1
    mults = 3 if sig.complex_ else 1      # karatsuba
    flops = 2.0 * (gm * sig.bm) * (gn * sig.bn) * (nk * sig.bk) * mults
    traffic = (gm * gn * nk * (sig.bm * sig.bk + sig.bk * sig.bn)
               + 2.0 * M * N) * item * planes
    peak = cost.PEAK_FLOPS_F32 / (2 if sig.letter in ("D", "Z") else 1)
    return max(flops / peak, traffic / cost.HBM_BW) * 1e6


def candidates(letter: str, trans: str, M: int, N: int, K: int,
               top: int = 4) -> List[KernelSig]:
    """The ``top`` analytically most promising kernels for this problem."""
    table = kernelgen.kernel_table(letter, trans)
    ranked = sorted(table, key=lambda s: (prior_us(s, M, N, K), s))
    return list(ranked[:max(1, top)])


# --------------------------------------------------------------------------
# Benchmark one size class.
# --------------------------------------------------------------------------

def _dtype(letter: str) -> torch.dtype:
    return {**kernelgen.BLAS_DTYPES, **kernelgen.FRAMEWORK_DTYPES}[letter]


def grain(letter: str) -> int:
    """Elements of the letter's type in 16 bytes: the row grain of the
    kernels' cp.async ring (S 4, D 2, H 8, C 2, Z 1)."""
    return max(1, 16 // _dtype(letter).itemsize)


def _on_grain(x: int, g: int) -> int:
    """``x`` rounded up to a multiple of ``g`` where that stays in x's
    bucket, else down; ``x`` itself when neither does."""
    b = classes_mod.bucket_index(x)
    for y in (-(x // -g) * g, x // g * g):
        if y >= 1 and classes_mod.bucket_index(y) == b:
            return y
    return x


def timed_shape(sc: SizeClass) -> Tuple[int, int, int]:
    """The (M, N, K) a class is timed at: its representative, with the
    row length of each stored operand (A's K for N, its M for T; B's N
    for N, its K for T) on the letter's 16-byte grain, inside the class's
    bucket."""
    M, N, K = classes_mod.representative(sc)
    g = grain(sc.letter)
    if sc.trans[0] == "N":
        K = _on_grain(K, g)
    else:
        M = _on_grain(M, g)
    if sc.trans[1] == "N":
        N = _on_grain(N, g)
    else:
        K = _on_grain(K, g)
    return M, N, K


def _maker(letter: str, device):
    """Seeded operand factory (module docstring): normal values, complex
    as re + i im with both parts normal."""
    dev = torch.device(device)
    dt = _dtype(letter)
    cx = kernelgen.IS_COMPLEX.get(letter, False)
    if dev.type == "cuda":
        g = torch.Generator(device=dev).manual_seed(SEED)
        plane = dt.to_real() if cx else (
            dt if dt in (torch.float32, torch.float64) else torch.float32)

        def mk(shape):
            x = torch.randn(shape, generator=g, dtype=plane, device=dev)
            if cx:
                x = torch.complex(x, torch.randn(shape, generator=g,
                                                 dtype=plane, device=dev))
            return x.to(dt)
        return mk
    g = torch.Generator().manual_seed(SEED)

    def mk(shape):
        x = torch.randn(shape, generator=g, dtype=torch.float64)
        if cx:
            x = torch.complex(x, torch.randn(shape, generator=g,
                                             dtype=torch.float64))
        return x.to(dt).to(device)
    return mk


def timed_path(sc: SizeClass, a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel's load path for stored ``a`` and ``b`` of class ``sc``:
    "complex" for C/Z, else the real kernel's by strides ("ring" or
    "scalar", ``iaat_gemm.load_mode``)."""
    from repro_torch.kernels import iaat_gemm
    if kernelgen.IS_COMPLEX.get(sc.letter, False):
        return "complex"
    opa = a if sc.trans[0] == "N" else a.T
    opb = b if sc.trans[1] == "N" else b.T
    return "ring" if iaat_gemm.load_mode(opa, opb) else "scalar"


def _operands(sc: SizeClass, M: int, N: int, K: int, device="cpu"):
    mk = _maker(sc.letter, device)
    a_shape = (M, K) if sc.trans[0] == "N" else (K, M)
    b_shape = (K, N) if sc.trans[1] == "N" else (N, K)
    return mk(a_shape), mk(b_shape)


def tune_class(sc: SizeClass, *, top: int = 4, warmup: int = 1,
               reps: int = 5, device="cuda") -> ProfileEntry:
    """Measure one size class at :func:`timed_shape`; returns the entry
    (best kernel sig, both timings, the load path timed) to record in the
    profile."""
    from repro_torch import api
    from repro_torch.kernels import iaat_gemm
    M, N, K = timed_shape(sc)
    a, b = _operands(sc, M, N, K, device)
    lib = try_measure(lambda: api._lib_gemm(a, b, None, 1.0, 0.0, sc.trans),
                      what=f"{sc.key} library", device=device,
                      warmup=warmup, reps=reps)
    best_sig: Optional[KernelSig] = None
    best: Optional[Measurement] = None
    for sig in candidates(sc.letter, sc.trans, M, N, K, top=top):
        # the K slices the tuned plan will run this signature with
        slices = plan_mod.build_plan(M, N, K, sc.letter, sc.trans,
                                     override=sig).regions[0].slices
        m = try_measure(lambda: iaat_gemm.gemm_region(sig, a, b,
                                                      slices=slices),
                        what=f"{sc.key} {sig.name}", device=device,
                        warmup=warmup, reps=reps)
        if m is not None and (best is None or m.median_us < best.median_us):
            best_sig, best = sig, m
    return ProfileEntry(best_sig, best, lib, path=timed_path(sc, a, b))


def tune_grouped_class(sc: SizeClass, *, G: int = 4, top: int = 4,
                       warmup: int = 1, reps: int = 5,
                       device="cuda") -> ProfileEntry:
    """Measure one grouped size class ON the grouped kernel: G per-group
    (C, K, N) problems (C = M of the class) through one ``batched_gemm``
    launch per candidate's blocks, against the executor's library einsum.
    Only the real letters have a grouped kernel.  K and N are put on the
    grain as :func:`timed_shape` puts them (x and w are stored NN)."""
    from repro_torch.kernels import grouped_gemm as _gg
    if sc.letter not in kernelgen.KERNEL_LETTERS:
        raise ValueError(f"no grouped kernel for letter {sc.letter!r}")
    C, N, K = timed_shape(dataclasses.replace(sc, trans="NN"))
    mk = _maker(sc.letter, device)
    x, w = mk((G, C, K)), mk((G, K, N))
    lib = try_measure(lambda: torch.einsum("gck,gkn->gcn", x, w),
                      what=f"grouped {sc.key} library", device=device,
                      warmup=warmup, reps=reps)
    best_sig: Optional[KernelSig] = None
    best: Optional[Measurement] = None
    for sig in candidates(sc.letter, "NN", C, N, K, top=top):
        blocks = (sig.bm, sig.bn, sig.bk)
        m = try_measure(lambda: _gg.batched_gemm(x, w, blocks=blocks),
                        what=f"grouped {sc.key} {sig.name}", device=device,
                        warmup=warmup, reps=reps)
        if m is not None and (best is None or m.median_us < best.median_us):
            best_sig, best = sig, m
    return ProfileEntry(best_sig, best, lib, path=_gg.load_path(x, w))


def _new_profile(device, device_kind: Optional[str]) -> DeviceProfile:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"cannot tune on device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: tune on the card, or pass "
                               "device='cpu' for a CPU profile")
        torch.backends.cuda.matmul.allow_tf32 = False
    return DeviceProfile(device_kind or device_kind_of(dev), mode=dev.type)


# --------------------------------------------------------------------------
# Budgeted sweep — the online tuner's entry point.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TuneTarget:
    """One class to re-time, with its traffic weight.  ``kind`` picks the
    harness: ``"gemm"`` times the 2-D region, ``"grouped"`` times
    ``batched_gemm`` and records under the ``grouped:`` namespace."""
    kind: str                       # "gemm" | "grouped"
    sc: SizeClass
    weight: float = 0.0


def _prime_library(targets: Sequence[TuneTarget], device) -> None:
    """One small library call per (harness, letter) of ``targets`` on the
    current stream, then a wait for the whole device: the first cuBLAS
    call of a thread on a stream sets up its handle and workspace, and
    work queued before the sweep (an engine's last step, the engine then
    held at the online tuner's gate) would share the SMs with a timing;
    no timing may hold either."""
    from repro_torch import api
    for kind, letter in sorted({(t.kind, t.sc.letter) for t in targets}):
        mk = _maker(letter, device)
        if kind == "grouped":
            torch.einsum("gck,gkn->gcn", mk((2, 8, 8)), mk((2, 8, 8)))
        else:
            api._lib_gemm(mk((8, 8)), mk((8, 8)), None, 1.0, 0.0, "NN")
    torch.cuda.synchronize(device)


def budgeted_sweep(targets: Sequence[TuneTarget], *, budget: int = 8,
                   top: int = 1, warmup: int = 0, reps: int = 1,
                   device="cuda", grouped_G: int = 4,
                   device_kind: Optional[str] = None,
                   ) -> Tuple[DeviceProfile, List[TuneTarget], int]:
    """Re-tune ``targets`` in order until the timing budget runs out.

    ``budget`` caps the stopwatch timings per call (each class costs at
    most ``1 + top``: the library plus the pruned candidates); a class is
    either fully timed or not touched.  On the card the library is first
    called once per letter and harness of ``targets`` and the device
    waited for (:func:`_prime_library`).  Returns ``(delta_profile,
    tuned_targets, timings_spent)``; the delta holds only the classes
    tuned, ready to merge."""
    prof = _new_profile(device, device_kind)
    per_class = 1 + max(1, top)
    spent = 0
    tuned: List[TuneTarget] = []
    if torch.device(device).type == "cuda":
        _prime_library(targets, device)
    with obs.span("tune.online_sweep"):
        for t in targets:
            if spent + per_class > budget:
                break
            with obs.span("tune.class"):
                if t.kind == "grouped":
                    entry = tune_grouped_class(
                        t.sc, G=grouped_G, top=top, warmup=warmup,
                        reps=reps, device=device)
                    prof.record_grouped(
                        t.sc, dataclasses.replace(entry, origin="online"))
                else:
                    entry = tune_class(t.sc, top=top, warmup=warmup,
                                       reps=reps, device=device)
                    prof.record(
                        t.sc, dataclasses.replace(entry, origin="online"))
            obs.counter("tune.classes_swept").inc()
            spent += per_class
            tuned.append(t)
    return prof, tuned, spent


def sweep(letters: Sequence[str] = ("S",),
          trans: Sequence[str] = ("NN",), *,
          min_dim: int = 8, max_dim: int = 512, cube_only: bool = False,
          top: int = 4, warmup: int = 1, reps: int = 5, device="cuda",
          device_kind: Optional[str] = None,
          progress: Optional[Callable[[SizeClass, ProfileEntry], None]] = None,
          ) -> DeviceProfile:
    """Run the tuning sweep on ``device`` and return the (unsaved)
    DeviceProfile; its mode is the device's type."""
    prof = _new_profile(device, device_kind)
    with obs.span("tune.sweep"):
        for sc in classes_mod.classes_up_to(letters, trans, max_dim,
                                            min_dim=min_dim,
                                            cube_only=cube_only):
            with obs.span("tune.class"):
                entry = tune_class(sc, top=top, warmup=warmup, reps=reps,
                                   device=device)
            obs.counter("tune.classes_swept").inc()
            prof.record(sc, entry)
            if progress is not None:
                progress(sc, entry)
    return prof
