"""The port's complex (C/Z) GEMM path against the JAX package's, on the
same numpy inputs.

The JAX side runs as its own tests run it: ``api.using(backend="pallas",
interpret=True)``, i.e. the Pallas ``_cx_body`` kernel in interpret mode,
inside a scoped ``jax.enable_x64(True)`` so that complex128 stays
complex128 there without changing the process-wide setting.  The port
runs on the CPU, where the kernel wrapper takes its plain Karatsuba
version (the CUDA kernel is held against that version on the card by
``chip_smoke.py``).  Tolerances are the reference's ``_RTOL``
(``tests/test_kernels_gemm.py:15``: C 2e-4, Z 1e-12, S 2e-5, D 1e-12),
atol = 10 x rtol as there: both sides take the same Karatsuba planes and
sum them in other orders.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import dispatch as jdispatch, kernelgen as jkernelgen
from repro.kernels import iaat_gemm as jiaat
from repro_torch import api
from repro_torch.core import (cost, dispatch, kernelgen, plan as plan_mod,
                              templates, vmem)
from repro_torch.kernels import iaat_gemm

_RTOL = {"S": 2e-5, "D": 1e-12, "C": 2e-4, "Z": 1e-12}
_NP = {"S": np.float32, "D": np.float64, "C": np.complex64,
       "Z": np.complex128}
_JNP = {"S": jnp.float32, "D": jnp.float64, "C": jnp.complex64,
        "Z": jnp.complex128}
_TORCH = {"S": torch.float32, "D": torch.float64, "C": torch.complex64,
          "Z": torch.complex128}
KERNEL = api.Policy(backend="kernel")
AUTO = api.Policy(backend="auto")
TRANS = ("NN", "NT", "TN", "TT")


def _np(rng, shape, letter):
    x = rng.randn(*shape)
    if letter in ("C", "Z"):
        x = x + 1j * rng.randn(*shape)
    return x.astype(_NP[letter])


def _close(got, want, letter):
    tol = _RTOL[letter]
    np.testing.assert_allclose(got.numpy().astype(np.complex128),
                               np.asarray(want).astype(np.complex128),
                               rtol=tol, atol=tol * 10)


def _jax_gemm(a, b, c, alpha, beta, ta, tb, letter):
    with jax.enable_x64(True):
        jc = None if c is None else jnp.asarray(c, _JNP[letter])
        with japi.using(backend="pallas", interpret=True):
            out = japi.gemm(jnp.asarray(a, _JNP[letter]),
                            jnp.asarray(b, _JNP[letter]), jc, alpha, beta,
                            ta, tb)
        return np.asarray(out)


#: (M, N, K, alpha, beta): K tails (21, 129, 200 are no multiple of any
#: bk), M/N overhangs of every block, complex alpha/beta with C, and
#: without C
_CASES = ((30, 50, 21, 1.5 - 0.5j, 0.25 + 2j),
          (5, 3, 200, 1.0, 0.0),
          (65, 3, 129, -0.5 + 1j, 0.0))


@pytest.mark.parametrize("letter", ["C", "Z"])
@pytest.mark.parametrize("trans", TRANS)
@pytest.mark.parametrize("policy", [KERNEL, AUTO], ids=["kernel", "auto"])
def test_cgemm_matches_jax(letter, trans, policy):
    rng = np.random.RandomState(abs(hash((letter, trans))) % 2**31)
    for (M, N, K, alpha, beta) in _CASES:
        a = _np(rng, (M, K) if trans[0] == "N" else (K, M), letter)
        b = _np(rng, (K, N) if trans[1] == "N" else (N, K), letter)
        c = _np(rng, (M, N), letter) if beta else None
        ta, tb = trans[0] == "T", trans[1] == "T"
        want = _jax_gemm(a, b, c, alpha, beta, ta, tb, letter)
        d = api.route("gemm", (M, N, K), letter, trans, policy=policy)
        assert d.use_kernel
        got = api.gemm(torch.from_numpy(a), torch.from_numpy(b),
                       None if c is None else torch.from_numpy(c),
                       alpha, beta, ta, tb, policy=policy)
        assert got.dtype == _TORCH[letter] and got.shape == (M, N)
        _close(got, want, letter)


@pytest.mark.parametrize("letter", ["C", "Z"])
def test_auto_answers_small_complex_like_jax(letter):
    """The fault this path had: under ``auto`` an 8x8 complex GEMM raised
    (the C/Z kernel table did not exist).  Both packages answer it, on
    the kernel path, with the same numbers."""
    rng = np.random.RandomState(8)
    a, b = _np(rng, (8, 8), letter), _np(rng, (8, 8), letter)
    with jax.enable_x64(True):
        with japi.using(backend="auto", interpret=True):
            jd = japi.route("gemm", (8, 8, 8), letter, "NN")
            want = np.asarray(japi.gemm(jnp.asarray(a, _JNP[letter]),
                                        jnp.asarray(b, _JNP[letter])))
    d = api.route("gemm", (8, 8, 8), letter, "NN", policy=AUTO)
    assert (d.use_kernel, d.source) == (jd.use_pallas, jd.source) == \
        (True, "analytical")
    got = api.gemm(torch.from_numpy(a), torch.from_numpy(b), policy=AUTO)
    _close(got, want, letter)


@pytest.mark.parametrize("letter,trans", [("C", "NT"), ("Z", "TN")])
def test_gemm_region_complex_matches_jax(letter, trans):
    """One complex region, kernel against kernel: the port's plain
    Karatsuba version against JAX's ``_cx_call`` in interpret mode, with
    complex alpha and beta and a C input."""
    rng = np.random.RandomState(11)
    M, N, K = 19, 70, 45
    a = _np(rng, (M, K) if trans[0] == "N" else (K, M), letter)
    b = _np(rng, (K, N) if trans[1] == "N" else (N, K), letter)
    c = _np(rng, (M, N), letter)
    alpha, beta = 0.75 + 1.25j, -1.5 + 0.5j
    jsig = jkernelgen.kernel_table(letter, trans)[0]
    with jax.enable_x64(True):
        want = np.asarray(jiaat.gemm_region(
            jsig, jnp.asarray(a, _JNP[letter]), jnp.asarray(b, _JNP[letter]),
            jnp.asarray(c, _JNP[letter]), alpha=alpha, beta=beta,
            interpret=True))
    sig = kernelgen.kernel_table(letter, trans)[0]
    assert sig.complex_ and sig.real_dtype == (
        torch.float32 if letter == "C" else torch.float64)
    got = iaat_gemm.gemm_region(sig, torch.from_numpy(a),
                                torch.from_numpy(b), torch.from_numpy(c),
                                alpha=alpha, beta=beta)
    assert got.dtype == _TORCH[letter]
    _close(got, want, letter)
    # the plain version is the Karatsuba: it differs from the 4-mult
    # product only by rounding
    p1, p2, p3 = templates.cmul_karatsuba(
        torch.from_numpy(a).real, torch.from_numpy(a).imag,
        torch.from_numpy(b).real, torch.from_numpy(b).imag, trans,
        sig.acc_dtype)
    cr, ci = templates.karatsuba_combine(p1, p2, p3)
    fr, fi = templates.cmul_fcmla(
        torch.from_numpy(a).real, torch.from_numpy(a).imag,
        torch.from_numpy(b).real, torch.from_numpy(b).imag, trans,
        sig.acc_dtype)
    _close(torch.complex(cr, ci), torch.complex(fr, fi).numpy(), letter)


def test_complex_census_every_instance_fits():
    """C/Z blocks stage each tile as (re, im) pairs, rows padded by two
    complex elements, streamed through a ring of bk/16 stages, and keep
    three accumulator planes: 12 C and 6 Z instances, the same blocks
    under every transposition, each within the 227 KB shared budget and
    the 64-register accumulator cap."""
    census = kernelgen.census()
    for letter, want in (("C", 12), ("Z", 6)):
        shapes = {t: {(s.bm, s.bn, s.bk) for s in
                      kernelgen.kernel_table(letter, t)} for t in TRANS}
        assert len({frozenset(v) for v in shapes.values()}) == 1
        assert all(census[f"{letter}GEMM_{t}"] == want for t in TRANS)
        for s in kernelgen.kernel_table(letter, "NN"):
            fp = s.footprint()
            real = vmem.footprint(s.bm, s.bn, s.bk, s.real_dtype,
                                  acc_dtype=s.acc_dtype)
            item = 2 * vmem.itemsize(s.real_dtype)
            assert fp.fits and fp.total == s.bk * (
                s.bm + s.bn + 2 * vmem.CX_PAD) * item
            assert (fp.stages, fp.ring_bytes) == (s.bk // vmem.CX_RING_K,
                                                  fp.total)
            assert fp.acc_regs == 3 * real.acc_regs <= vmem.ACC_REG_CAP
            assert vmem.thread_layout_ok(s.bm, s.bn)
    assert sum(1 for i in kernelgen.instances() if i[0] == "C") == 12
    assert sum(1 for i in kernelgen.instances() if i[0] == "Z") == 6
    # the largest C block (16 x 256 or 32 x 128 or 64 x 64) is 4096
    # outputs; Z 2048
    assert max(s.bm * s.bn for s in kernelgen.kernel_table("C", "NN")) \
        == 4096
    assert max(s.bm * s.bn for s in kernelgen.kernel_table("Z", "NN")) \
        == 2048


@pytest.mark.parametrize("letter", ["C", "Z"])
def test_complex_plans_cover_the_extent(letter):
    """Every paper-grid size and some ragged ones: the regions, clipped
    to (M, N), partition C, and every region runs a table instance."""
    sizes = [1, 2, 7, 16, 33, 65, 80, 130, 512]
    for trans in TRANS:
        table = kernelgen.kernel_table(letter, trans)
        for M, N in itertools.product(sizes, sizes):
            p = plan_mod.build_plan(M, N, 33, letter, trans)
            p.tiling.validate_cover()
            hits = np.zeros((M, N), np.int32)
            for r in p.regions:
                assert r.sig in table
                hits[r.m0:min(M, r.m0 + r.m_extent),
                     r.n0:min(N, r.n0 + r.n_extent)] += 1
            assert (hits == 1).all(), (M, N, trans)


def test_complex_roofline_counts_the_karatsuba():
    """The bound counts 6MNK + 5MN real operations (not the paper's 8MNK)
    at the plane type's peak, and 8 (C) or 16 (Z) bytes an element."""
    for letter, peak, item in (("C", cost.PEAK_FLOPS_F32, 8),
                               ("Z", cost.PEAK_FLOPS_F64, 16)):
        r = cost.gemm_roofline(80, 70, 60, letter)
        assert r.flops == 6 * 80 * 70 * 60 + 5 * 80 * 70
        assert r.compute_s == pytest.approx(r.flops / peak)
        assert r.hbm_bytes == (80 * 60 + 60 * 70 + 80 * 70) * item


@pytest.mark.parametrize("letter", ["S", "D", "C", "Z"])
def test_traditional_gemm_matches_jax(letter):
    """The pack-step baseline (pad + transpose-normalise, one fixed
    kernel) against JAX's, with alpha/beta and C."""
    rng = np.random.RandomState(5)
    M, N, K = 30, 20, 45
    a = _np(rng, (K, M), letter)           # stored transposed
    b = _np(rng, (K, N), letter)
    c = _np(rng, (M, N), letter)
    cplx = letter in ("C", "Z")
    alpha = 1.25 - 0.5j if cplx else 1.25
    beta = 0.5 + 1j if cplx else 0.5
    with jax.enable_x64(True):
        want = np.asarray(jdispatch.traditional_gemm(
            jnp.asarray(a, _JNP[letter]), jnp.asarray(b, _JNP[letter]),
            jnp.asarray(c, _JNP[letter]), alpha, beta, trans_a=True,
            interpret=True))
    got = dispatch.traditional_gemm(torch.from_numpy(a), torch.from_numpy(b),
                                    torch.from_numpy(c), alpha, beta,
                                    trans_a=True)
    assert got.dtype == _TORCH[letter] and got.shape == (M, N)
    _close(got, want, letter)
    bm, bn, bk = dispatch.PACK_SIG[letter]
    assert kernelgen.KernelSig(letter, "NN", bm, bn, bk) in \
        kernelgen.kernel_table(letter, "NN")
    Mp, Np, Kp = -(-M // bm) * bm, -(-N // bn) * bn, -(-K // bk) * bk
    assert dispatch.traditional_pack_bytes(M, N, K, _TORCH[letter]) == \
        2 * (Mp * Kp + Kp * Np) * vmem.itemsize(_TORCH[letter])


def test_complex_operand_requiring_grad_raises():
    """Complex regions are forward-only, as in the reference: a complex
    operand that records a gradient raises, on every kernel route, and is
    never silently served by the plain path.  The library path, plain
    torch, still differentiates."""
    a = torch.randn(6, 5, dtype=torch.complex64, requires_grad=True)
    b = torch.randn(5, 4, dtype=torch.complex64)
    for pol in (KERNEL, AUTO):
        with pytest.raises(RuntimeError, match="forward-only"):
            api.gemm(a, b, policy=pol)
    sig = kernelgen.kernel_table("C", "NN")[0]
    with pytest.raises(RuntimeError, match="forward-only"):
        iaat_gemm.gemm_region(sig, a, b)
    with torch.no_grad():
        out = api.gemm(a, b, policy=KERNEL)
    np.testing.assert_allclose(out.numpy(), (a.detach() @ b).numpy(),
                               rtol=2e-4, atol=2e-3)
    api.gemm(a, b, policy=api.Policy(backend="library")).abs().sum() \
        .backward()
    assert a.grad is not None and a.grad.shape == a.shape


@pytest.mark.parametrize("letter", ["C", "Z"])
def test_complex_strided_and_conjugated_views(letter):
    """Sliced, transposed and lazily conjugated operands reach the kernel
    path as views and give numpy's product."""
    rng = np.random.RandomState(9)
    big_a = torch.from_numpy(_np(rng, (40, 50), letter))
    big_b = torch.from_numpy(_np(rng, (60, 30), letter))
    a = big_a[3:33:2, 5:45]                 # (15, 40), row stride 100
    b = big_b[10:50, ::2].T                 # (15, 40): op(B) = b.T
    assert not a.is_contiguous() and not b.is_contiguous()
    want = a.numpy() @ b.numpy().T
    got = api.gemm(a, b, trans_b=True, policy=KERNEL)
    _close(got, want, letter)
    got = api.gemm(a.conj(), b, trans_b=True, policy=KERNEL)
    _close(got, np.conj(a.numpy()) @ b.numpy().T, letter)
