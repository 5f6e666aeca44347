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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core import cost, kernelgen, vmem
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

def _maker(letter: str, device):
    """Seeded operand factory: normal values made on the host from one
    ``torch.Generator`` (so a CPU and a card sweep time the same numbers),
    complex as re + i im with both parts normal."""
    g = torch.Generator().manual_seed(SEED)
    dt = {**kernelgen.BLAS_DTYPES, **kernelgen.FRAMEWORK_DTYPES}[letter]

    def mk(shape):
        x = torch.randn(shape, generator=g, dtype=torch.float64)
        if kernelgen.IS_COMPLEX.get(letter, False):
            x = torch.complex(x, torch.randn(shape, generator=g,
                                             dtype=torch.float64))
        return x.to(dt).to(device)
    return mk


def _operands(sc: SizeClass, M: int, N: int, K: int, device="cpu"):
    mk = _maker(sc.letter, device)
    a_shape = (M, K) if sc.trans[0] == "N" else (K, M)
    b_shape = (K, N) if sc.trans[1] == "N" else (N, K)
    return mk(a_shape), mk(b_shape)


def tune_class(sc: SizeClass, *, top: int = 4, warmup: int = 1,
               reps: int = 5, device="cuda") -> ProfileEntry:
    """Measure one size class at its representative shape; returns the
    entry (best kernel sig + both timings) to record in the profile."""
    from repro_torch import api
    from repro_torch.kernels import iaat_gemm
    M, N, K = classes_mod.representative(sc)
    a, b = _operands(sc, M, N, K, device)
    lib = try_measure(lambda: api._lib_gemm(a, b, None, 1.0, 0.0, sc.trans),
                      what=f"{sc.key} library", device=device,
                      warmup=warmup, reps=reps)
    best_sig: Optional[KernelSig] = None
    best: Optional[Measurement] = None
    for sig in candidates(sc.letter, sc.trans, M, N, K, top=top):
        m = try_measure(lambda: iaat_gemm.gemm_region(sig, a, b),
                        what=f"{sc.key} {sig.name}", device=device,
                        warmup=warmup, reps=reps)
        if m is not None and (best is None or m.median_us < best.median_us):
            best_sig, best = sig, m
    return ProfileEntry(best_sig, best, lib)


def tune_grouped_class(sc: SizeClass, *, G: int = 4, top: int = 4,
                       warmup: int = 1, reps: int = 5,
                       device="cuda") -> ProfileEntry:
    """Measure one grouped size class ON the grouped kernel: G per-group
    (C, K, N) problems (C = M of the class) through one ``batched_gemm``
    launch per candidate's blocks, against the executor's library einsum.
    Only the real letters have a grouped kernel."""
    from repro_torch.kernels import grouped_gemm as _gg
    if sc.letter not in kernelgen.KERNEL_LETTERS:
        raise ValueError(f"no grouped kernel for letter {sc.letter!r}")
    C, N, K = classes_mod.representative(sc)
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
    return ProfileEntry(best_sig, best, lib)


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


def budgeted_sweep(targets: Sequence[TuneTarget], *, budget: int = 8,
                   top: int = 1, warmup: int = 0, reps: int = 1,
                   device="cuda", grouped_G: int = 4,
                   device_kind: Optional[str] = None,
                   ) -> Tuple[DeviceProfile, List[TuneTarget], int]:
    """Re-tune ``targets`` in order until the timing budget runs out.

    ``budget`` caps the stopwatch timings per call (each class costs at
    most ``1 + top``: the library plus the pruned candidates); a class is
    either fully timed or not touched.  Returns ``(delta_profile,
    tuned_targets, timings_spent)``; the delta holds only the classes
    tuned, ready to merge."""
    prof = _new_profile(device, device_kind)
    per_class = 1 + max(1, top)
    spent = 0
    tuned: List[TuneTarget] = []
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
