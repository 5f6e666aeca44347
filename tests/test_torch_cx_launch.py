"""The complex kernel's one launch a plan and its f64 tensor-core arithmetic, on the CPU.

The CUDA kernel (``csrc/cx_gemm.cu``) runs every region of a complex plan
in one launch, over the plan's region table (``Plan.launch_tables``): a
block finds its region (the last row whose first block is at or before
it, :func:`_table_region` here) and runs that region's instance.  Z multiplies on the f64 tensor cores (``mma.sync`` m16n8k8
.f64), C on f32 FMAs with pairs of rows and columns half a block apart.
None of that runs here, so each piece is checked as what the CPU can see:

* the table: for every C/Z plan of the paper's grid (2..80 in steps of 2,
  to 32 for TN, x NN/NT/TN/TT) and the grid's ragged non-cubes, the
  table's blocks tile M x N exactly once, each block inside its own
  region; a plan of more regions than a launch takes is cut into tables
  of at most 64;
* the Z fragments: the kernel's shared-memory reads walked lane by lane
  through the PTX fragment map of m16n8k8 .f64, the mma emulated on the
  matrices the lanes hold, against the plain Karatsuba at Z's tolerance
  (1e-12 of the largest value, ``chip_smoke.py`` GRID_TOL: both take f64
  sums of the same products in other orders); every output of every Z
  instance held once; the C thread layout likewise;
* the launch: the C call with the built library stubbed out, one call
  and one counted launch a table, its arguments;
* the CPU path over the table against JAX's Pallas ``_cx_body`` in
  interpret mode, on the same numpy inputs, at the reference's ``_RTOL``.

The kernel itself is held against its plain version on the card by
``chip_smoke.py``.
"""
import itertools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api
from repro_torch.configs import paper_gemm
from repro_torch.core import kernelgen, plan as plan_mod, vmem
from repro_torch.core.kernelgen import KernelSig
from repro_torch.kernels import build, iaat_gemm

TRANS = ("NN", "NT", "TN", "TT")
#: the ragged non-cubes every letter and transposition of the grid runs
#: (``chip_smoke.py`` GRID_RAGGED)
RAGGED = ((7, 130, 33), (65, 3, 129), (1, 1, 1), (33, 300, 130))
_RTOL = {"C": 2e-4, "Z": 1e-12}
_NP = {"C": np.complex64, "Z": np.complex128}
_JNP = {"C": jnp.complex64, "Z": jnp.complex128}


def _grid_dims(trans):
    cfg = paper_gemm.CONFIG
    return [(n, n, n) for n in cfg.sizes(trans)] + list(RAGGED)


def _table_blocks(table):
    """The blocks of one launch over ``table``, its grid."""
    start, m0, m_hi, _, _, gn, bm, _, _ = table[-1]
    return start + -(-(m_hi - m0) // bm) * gn


def _table_region(table, block):
    """The row of ``table`` that block ``block`` of the launch runs, as
    the kernel finds it: the last whose first block is at or before it."""
    r = 0
    while r + 1 < len(table) and block >= table[r + 1][0]:
        r += 1
    return r


def _cover(M, N, tables):
    """Every block of every table, placed as the kernel places it; the
    hits per output element."""
    hits = np.zeros((M, N), np.int32)
    for table in tables:
        assert 1 <= len(table) <= plan_mod.LAUNCH_REGIONS
        assert table[0][0] == 0
        for bid in range(_table_blocks(table)):
            start, m0, m_hi, n0, n_hi, gn, bm, bn, _ = \
                table[_table_region(table, bid)]
            local = bid - start
            bm0 = m0 + (local // gn) * bm
            bn0 = n0 + (local % gn) * bn
            # inside its region, and writing some element
            assert m0 <= bm0 < m_hi and n0 <= bn0 < n_hi
            hits[bm0:min(bm0 + bm, m_hi), bn0:min(bn0 + bn, n_hi)] += 1
    return hits


@pytest.mark.parametrize("letter", ["C", "Z"])
@pytest.mark.parametrize("trans", TRANS)
def test_launch_table_tiles_every_grid_plan_once(letter, trans):
    table = kernelgen.kernel_table(letter, trans)
    for M, N, K in _grid_dims(trans):
        p = plan_mod.build_plan(M, N, K, letter, trans)
        tables = p.launch_tables
        assert len(tables) == 1, (M, N, K)          # one launch
        rows = tables[0]
        assert len(rows) == sum(r.m0 < M and r.n0 < N for r in p.regions)
        for row in rows:
            assert KernelSig(letter, trans, *row[6:]) in table
        assert (_cover(M, N, tables) == 1).all(), (M, N, K)


def _many_regions(count):
    """A plan-like run of ``count`` stripes of 16 rows, each its own
    region, alternating two widths of block."""
    regions = []
    for i in range(count):
        sig = KernelSig("C", "NN", 16, 64 if i % 2 else 128, 32)
        regions.append(plan_mod.Region(sig, 16 * i, 0, 1, 2 if i % 2 else 1,
                                       1))
    return regions


@pytest.mark.parametrize("count", [1, 2, 63, 64, 65, 130])
def test_launch_tables_hold_at_most_64_regions(count):
    M, N = 16 * count - 5, 120
    tables = plan_mod.launch_tables(M, N, _many_regions(count))
    assert len(tables) == -(-count // plan_mod.LAUNCH_REGIONS)
    assert [len(t) for t in tables[:-1]] == \
        [plan_mod.LAUNCH_REGIONS] * (len(tables) - 1)
    assert (_cover(M, N, tables) == 1).all()
    assert plan_mod.LAUNCH_REGIONS == api.MAX_PLAN_REGIONS
    src = (Path(build.__file__).parent / "csrc" / "cx_gemm.cu").read_text()
    assert re.search(r"constexpr int MAX_REGIONS = (\d+);", src).group(1) \
        == str(plan_mod.LAUNCH_REGIONS)


def test_launch_table_skips_regions_past_the_output():
    sig = KernelSig("Z", "NN", 16, 64, 32)
    regions = [plan_mod.Region(sig, 0, 0, 2, 2, 1),
               plan_mod.Region(sig, 32, 0, 1, 2, 1),     # past M
               plan_mod.Region(sig, 0, 128, 2, 1, 1)]    # past N
    (rows,) = plan_mod.launch_tables(20, 100, regions)
    assert rows == ((0, 0, 20, 0, 100, 2, 16, 64, 32),)
    assert _table_blocks(rows) == 4


# -- the Z fragments --------------------------------------------------------

def _z_layout(bm, bn):
    """cx_gemm.cu ZLayout: (WN, WM, MT, NF), the 8 warps as WM row strips
    of MT m16 tiles x WN column strips of NF n8 tiles; two n8 tiles a
    warp where the block is wide enough."""
    wn = max(min(bn // 16, 8), 8 // (bm // 16))
    wm = 8 // wn
    return wn, wm, bm // (16 * wm), bn // (8 * wn)


def _z_block(s, A, B):
    """One (bm, bn) block of A (bm x K) @ B (K x bn), complex128, as the
    kernel computes it: the tiles staged k-major as (re, im) pairs in
    rows of bm + 2 (bn + 2) complex elements, 16 k rows a stage; each
    lane's fragment registers read at the kernel's shared-memory indices,
    the Karatsuba sums formed as read; every m16n8k8 mma emulated on the
    (16 x 8) and (8 x 8) matrices the lanes hold (PTX map below); the
    accumulators read back per lane and combined.  Returns the block and
    the count of times each output was held."""
    bm, bn = s.bm, s.bn
    K = A.shape[1]
    lda, ldb = bm + vmem.CX_PAD, bn + vmem.CX_PAD
    wn, wm, mt_n, nf_n = _z_layout(bm, bn)
    acc = {}                  # (warp, mt, nf, plane) -> (32, 4) f64
    for k0 in range(0, K, vmem.CX_RING_K):
        As = np.zeros(vmem.CX_RING_K * lda, np.complex128)
        Bs = np.zeros(vmem.CX_RING_K * ldb, np.complex128)
        for k in range(vmem.CX_RING_K):
            if k0 + k < K:
                As[k * lda:k * lda + bm] = A[:, k0 + k]
                Bs[k * ldb:k * ldb + bn] = B[k0 + k, :]
        for kk in (0, 8):
            for warp in range(vmem.NTHREADS // 32):
                col0 = (warp % wn) * nf_n * 8
                row0 = (warp // wn) * mt_n * 16
                for mt, nf in itertools.product(range(mt_n), range(nf_n)):
                    a = np.zeros((32, 4), np.complex128)
                    b = np.zeros((32, 2), np.complex128)
                    for lane in range(32):
                        gid, tig = divmod(lane, 4)
                        for q in range(4):
                            a[lane, q] = As[(kk + tig + 4 * (q >> 1)) * lda
                                            + row0 + mt * 16 + gid
                                            + 8 * (q & 1)]
                        for q in range(2):
                            b[lane, q] = Bs[(kk + tig + 4 * q) * ldb + col0
                                            + nf * 8 + gid]
                    planes = (a.real, a.imag, a.real + a.imag), \
                        (b.real, b.imag, b.real + b.imag)
                    for pl in range(3):
                        am = np.zeros((16, 8))
                        bmat = np.zeros((8, 8))
                        for lane in range(32):
                            gid, tig = divmod(lane, 4)
                            for q in range(4):
                                am[gid + 8 * (q & 1), tig + 4 * (q >> 1)] = \
                                    planes[0][pl][lane, q]
                            for q in range(2):
                                bmat[tig + 4 * q, gid] = planes[1][pl][lane, q]
                        d = am @ bmat
                        key = (warp, mt, nf, pl)
                        cur = acc.setdefault(key, np.zeros((32, 4)))
                        for lane in range(32):
                            gid, tig = divmod(lane, 4)
                            for q in range(4):
                                cur[lane, q] += d[gid + 8 * (q >> 1),
                                                  2 * tig + (q & 1)]
    out = np.zeros((bm, bn), np.complex128)
    held = np.zeros((bm, bn), np.int32)
    for warp in range(vmem.NTHREADS // 32):
        for mt, nf in itertools.product(range(mt_n), range(nf_n)):
            p1, p2, p3 = (acc[(warp, mt, nf, pl)] for pl in range(3))
            for lane in range(32):
                gid, tig = divmod(lane, 4)
                for q in range(4):
                    m = (warp // wn) * mt_n * 16 + mt * 16 + gid + \
                        8 * (q >> 1)
                    n = (warp % wn) * nf_n * 8 + nf * 8 + 2 * tig + (q & 1)
                    cr = p1[lane, q] - p2[lane, q]
                    ci = p3[lane, q] - p1[lane, q] - p2[lane, q]
                    out[m, n] = cr + 1j * ci
                    held[m, n] += 1
    return out, held


@pytest.mark.parametrize("bm,bn,K", [(16, 64, 37), (16, 128, 16),
                                     (32, 64, 70)])
def test_dmma_fragments_match_the_plain_karatsuba(bm, bn, K):
    s = KernelSig("Z", "NN", bm, bn, 64 if K > 32 else 32)
    assert s in kernelgen.kernel_table("Z", "NN")
    rng = np.random.RandomState(bm + bn + K)
    A = rng.randn(bm, K) + 1j * rng.randn(bm, K)
    B = rng.randn(K, bn) + 1j * rng.randn(K, bn)
    got, held = _z_block(s, A, B)
    assert (held == 1).all()
    want = iaat_gemm.cx_region_plain(s, torch.from_numpy(A),
                                     torch.from_numpy(B)).numpy()
    assert np.abs(got - want).max() <= _RTOL["Z"] * np.abs(want).max()


def test_every_z_instance_fits_the_warp_layout():
    """8 warps as WM x WN strips, each holding MT x NF m16n8 tiles of
    three planes (two n8 tiles a warp at 16 x 128 and 32 x 64): the
    table's accumulator count, within the cap."""
    want = {(16, 64): (8, 1, 1, 1), (16, 128): (8, 1, 1, 2),
            (32, 64): (4, 2, 1, 2)}
    for s in kernelgen.kernel_table("Z", "NN"):
        wn, wm, mt, nf = _z_layout(s.bm, s.bn)
        assert (wn, wm, mt, nf) == want[(s.bm, s.bn)]
        assert wn * wm == 8 and mt * 16 * wm == s.bm and \
            nf * 8 * wn == s.bn
        # three planes of mt x nf tiles of 4 f64 values, 2 registers each
        assert 3 * mt * nf * 4 * 2 == s.footprint().acc_regs <= \
            vmem.ACC_REG_CAP
        assert s.bk % vmem.CX_RING_K == 0 and vmem.CX_RING_K % 8 == 0


def test_every_c_instance_holds_each_output_once():
    """The C thread layout: TM rows (pairs BM/2 apart) x 4 columns (pairs
    BN/2 apart) a thread hold every output of the block once; staged rows
    keep an even number of pairs, so the 16-byte reads stay aligned."""
    for s in kernelgen.kernel_table("C", "NN"):
        tx_n = s.bn // 4
        ty_n = vmem.NTHREADS // tx_n
        tm = s.bm // ty_n
        assert tm in (1, 2, 4)
        held = np.zeros((s.bm, s.bn), np.int32)
        for t in range(vmem.NTHREADS):
            tx, ty = t % tx_n, t // tx_n
            for i, j in itertools.product(range(tm), range(4)):
                m = ty if tm == 1 else (i >> 1) * (s.bm // 2) + 2 * ty + \
                    (i & 1)
                n = (j >> 1) * (s.bn // 2) + 2 * tx + (j & 1)
                held[m, n] += 1
        assert (held == 1).all(), s.name
        # rows of the staged tiles stay 16-byte aligned for the reads
        assert (s.bm + vmem.CX_PAD) % 2 == 0 == (s.bn + vmem.CX_PAD) % 2


# -- the launch, with the library stubbed out --------------------------------

class _FakeLib:
    """Stands in for the built library: records each C call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda idx: 7, raising=False)
    iaat_gemm._cx_entry.cache_clear()
    iaat_gemm.reset_launch_count()
    yield lib
    iaat_gemm._cx_entry.cache_clear()
    iaat_gemm.reset_launch_count()


@pytest.mark.parametrize("letter,trans,M,N,K", [("C", "NN", 80, 80, 80),
                                                ("Z", "TT", 33, 300, 130),
                                                ("C", "NT", 1, 1, 1)])
def test_one_call_and_one_launch_a_plan(fake_lib, letter, trans, M, N, K):
    dt = kernelgen.BLAS_DTYPES[letter]
    a = torch.zeros((M, K) if trans[0] == "N" else (K, M), dtype=dt)
    b = torch.zeros((K, N) if trans[1] == "N" else (N, K), dtype=dt)
    c = torch.zeros((M, N), dtype=dt)
    p = plan_mod.build_plan(M, N, K, letter, trans)
    out = iaat_gemm._launch_cx(letter, trans, p.c_launch_tables, a, b, c,
                               0.5 + 1j, 2.0)
    assert iaat_gemm.launch_count("cx_gemm") == 1
    assert iaat_gemm.launch_count("iaat_gemm") == 0
    ((name, args),) = fake_lib.calls
    assert name == f"cx_gemm_{letter}"
    tab, n = args[0], args[1]
    (rows,) = p.launch_tables
    assert n == len(rows) and list(tab) == [v for r in rows for v in r]
    opa = a.T if trans[0] == "T" else a
    opb = b.T if trans[1] == "T" else b
    assert args[2:5] == (opa.data_ptr(), *opa.stride())
    assert args[5:8] == (opb.data_ptr(), *opb.stride())
    assert args[8:11] == (c.data_ptr(), *c.stride())
    assert args[11:14] == (out.data_ptr(), *out.stride())
    assert args[14:] == (K, 0.5, 1.0, 2.0, 0.0, 7)
    # the same plan reuses its C arrays
    iaat_gemm._launch_cx(letter, trans, p.c_launch_tables, a, b, None, 1.0,
                         0.0)
    assert fake_lib.calls[1][1][0] is tab and fake_lib.calls[1][1][8] is None
    assert iaat_gemm.launch_count("cx_gemm") == 2


def test_a_launch_per_table_past_64_regions(fake_lib):
    regions = _many_regions(130)
    M, N = 16 * 130, 120
    tables = plan_mod.c_tables(plan_mod.launch_tables(M, N, regions))
    a = torch.zeros((M, 8), dtype=torch.complex64)
    b = torch.zeros((8, N), dtype=torch.complex64)
    iaat_gemm._launch_cx("C", "NN", tables, a, b, None, 1.0, 0.0)
    assert [args[1] for _, args in fake_lib.calls] == [64, 64, 2]
    assert iaat_gemm.launch_count("cx_gemm") == 3


def test_a_region_alone_is_one_launch_of_its_table(fake_lib):
    """``gemm_region`` with a complex signature (the tuner's candidates,
    the pack baseline): one launch over a one-row table of its blocks."""
    s = KernelSig("Z", "NT", 32, 64, 64)
    a = torch.zeros((70, 9), dtype=torch.complex128)
    b = torch.zeros((130, 9), dtype=torch.complex128)
    iaat_gemm._launch(s, a, b, None, 1.0, 0.0, None)
    ((_, args),) = fake_lib.calls
    assert args[1] == 1 and list(args[0]) == [0, 0, 70, 0, 130, 3, 32, 64,
                                              64]
    assert iaat_gemm.launch_count("cx_gemm") == 1
    with pytest.raises(ValueError, match="no K slices"):
        iaat_gemm._launch(s, a, b, None, 1.0, 0.0, None, slices=2)


# -- the CPU path over the table, against JAX --------------------------------

@pytest.mark.parametrize("letter", ["C", "Z"])
@pytest.mark.parametrize("M,N,K", [(80, 80, 80), (33, 300, 130),
                                   (65, 3, 129)])
def test_table_path_matches_jax(letter, M, N, K):
    """``plan.execute`` of a multi-region complex plan, which the CPU runs
    region by region from the launch table, against JAX's Pallas
    ``_cx_body`` (interpret mode) with complex alpha and beta and C."""
    rng = np.random.RandomState(M + N + K)

    def mk(*shape):
        return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(
            _NP[letter])

    a, b, c = mk(K, M), mk(K, N), mk(M, N)
    alpha, beta = 1.5 - 0.5j, 0.25 + 2j
    with jax.enable_x64(True):
        with japi.using(backend="pallas", interpret=True):
            want = np.asarray(japi.gemm(
                jnp.asarray(a, _JNP[letter]), jnp.asarray(b, _JNP[letter]),
                jnp.asarray(c, _JNP[letter]), alpha, beta, True, False))
    p = plan_mod.build_plan(M, N, K, letter, "TN")
    got = plan_mod.execute(p, torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(c), alpha, beta)
    tol = _RTOL[letter]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * 10)
    assert iaat_gemm.launch_count() == 0
