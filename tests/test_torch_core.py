"""repro_torch.core against the JAX package's core: the ARMv8 tiler is pure
combinatorics and must agree EXACTLY; the Hopper table, tiler and plans
must keep their invariants (exact cover, legal blocks, kernel limits)."""
import itertools

import numpy as np
import pytest
import torch

from repro.core import cost as jcost, tiler as jtiler
from repro_torch.core import (cost, kernelgen, paper_table, plan as plan_mod,
                              templates, tiler, vmem)

LETTERS = ("S", "D", "C", "Z")
TRANS = ("NN", "NT", "TN", "TT")


def _blocks(t):
    return tuple((b.m0, b.n0, b.m, b.n) for b in t.blocks)


@pytest.mark.parametrize("letter,trans", list(itertools.product(LETTERS,
                                                                TRANS)))
def test_tile_armv8_equals_reference(letter, trans):
    """Every (letter, trans) of test_tiler.py's sweeps, M and N over the
    sweep's 1..96 range: the same blocks, in the same order (no
    tolerance: the tiler is integer combinatorics)."""
    sizes = (1, 2, 3, 8, 13, 15, 16, 17, 31, 48, 64, 77, 96)
    for M, N in itertools.product(sizes, sizes):
        got = tiler.tile_armv8(M, N, letter, trans, "dp")
        want = jtiler.tile_armv8(M, N, letter, trans, "dp")
        assert (got.M, got.N, got.method) == (want.M, want.N, want.method)
        assert _blocks(got) == _blocks(want), (M, N, letter, trans)
        assert got.coeff == want.coeff


def test_tile_armv8_greedy_equals_reference():
    """The paper's Algorithm 2 (greedy, SGEMM_NN special case) over the
    1..64 sweep of test_dp_never_worse_than_greedy."""
    for M, N in itertools.product(range(1, 65, 3), range(1, 65, 5)):
        got = tiler.tile_armv8(M, N, "S", "NN", "greedy")
        want = jtiler.tile_armv8(M, N, "S", "NN", "greedy")
        assert _blocks(got) == _blocks(want), (M, N)
        assert tiler.tile_armv8(M, N, "S", "NN", "dp").coeff <= got.coeff


def test_paper_fig2_coefficient_72():
    t = tiler.tile_armv8(15, 15, "S", "NN", "dp")
    assert t.coeff == paper_table.PAPER_FIG2_IAAT_COEFF == 72
    assert t.memops(15) == 72 * 15 + 2 * 15 * 15
    assert sorted((b.m, b.n) for b in t.blocks) == \
        [(3, 2), (3, 13), (12, 3), (12, 6), (12, 6)]


def test_memops_objective_matches_reference():
    blocks = [(12, 6), (12, 6), (12, 3), (3, 13), (3, 2)]
    assert cost.memops_blocks(blocks, 15, 15, 15) == \
        jcost.memops_blocks(blocks, 15, 15, 15) == 72 * 15 + 450


def test_hopper_table_census_invariants():
    """Every signature obeys the kernel's limits (thread layout, grains,
    227 KB shared budget, accumulator register cap); the four
    transpositions share one block set (the kernels read strides).  The
    table covers S/D/H (the real kernel) and C/Z (the complex Karatsuba
    kernel, with two planes staged and three accumulated)."""
    census = kernelgen.census()
    assert set(census) == {f"{L}GEMM_{t}" for L in kernelgen.TABLE_LETTERS
                           for t in TRANS}
    assert set(kernelgen.TABLE_LETTERS) == {"S", "D", "H", "C", "Z"}
    for letter in kernelgen.TABLE_LETTERS:
        fams = {t: kernelgen.kernel_table(letter, t) for t in TRANS}
        shapes = {t: {(s.bm, s.bn, s.bk) for s in fam}
                  for t, fam in fams.items()}
        assert len({frozenset(v) for v in shapes.values()}) == 1
        for t, fam in fams.items():
            assert census[f"{letter}GEMM_{t}"] == len(fam) > 0
            assert list(fam) == sorted(fam)
            for s in fam:
                fp = s.footprint()
                assert fp.fits
                assert fp.total <= vmem.SMEM_OPTIN_BYTES
                assert fp.acc_regs <= vmem.ACC_REG_CAP
                assert s.bm % vmem.GRAIN_M == 0 and s.bn % vmem.GRAIN_N == 0
                assert vmem.thread_layout_ok(s.bm, s.bn)
    assert sum(census.values()) == len(kernelgen.full_table())
    assert len(kernelgen.instances()) == 22 + 18 + 22 + 12 + 6
    assert [census[f"{L}GEMM_NN"] for L in "CZ"] == [12, 6]
    with pytest.raises(ValueError):
        kernelgen.kernel_table("Q", "NN")


@pytest.mark.parametrize("letter", kernelgen.TABLE_LETTERS)
def test_hopper_tiling_covers_aligned_extent(letter):
    rng = np.random.RandomState(7)
    dims = [1, 4, 16, 32, 33, 129, 700, 2048] + list(rng.randint(1, 700, 6))
    for trans in TRANS:
        table = kernelgen.kernel_table(letter, trans)
        legal = {(s.bm, s.bn) for s in table}
        for M, N in itertools.product(dims, dims):
            t = tiler.tile_hopper(int(M), int(N), letter, trans)
            t.validate_cover()
            assert t.M == vmem.align_m(M, table[0].real_dtype)
            assert t.N == vmem.align_n(N, table[0].real_dtype)
            assert all((b.m, b.n) in legal for b in t.blocks)


@pytest.mark.parametrize("M,N,K,trans", [
    (4, 50432, 2048, "NN"), (32, 8192, 2048, "NN"), (30, 50, 21, "TT"),
    (129, 257, 130, "NT"), (1, 1, 1, "TN"), (700, 333, 64, "NN")])
def test_plan_regions_cover_c_exactly_once(M, N, K, trans):
    """plan.execute writes every element of its torch.empty output: the
    regions, clipped to (M, N), partition C."""
    p = plan_mod.build_plan(M, N, K, "H", trans)
    hits = np.zeros((M, N), np.int32)
    for r in p.regions:
        assert r.sig.letter == "H" and r.sig.trans == trans
        assert r.sig in kernelgen.kernel_table("H", trans)
        hits[r.m0:min(M, r.m0 + r.m_extent),
             r.n0:min(N, r.n0 + r.n_extent)] += 1
    assert (hits == 1).all()


def test_main_path_plans_are_few_launches():
    """olmo-1b decode and prefill shapes: the tied 50432-wide unembed is
    one region of 197 (16 x 256) blocks; d_ff projections one region."""
    p = plan_mod.build_plan(4, 50432, 2048, "H", "NN")
    assert [(r.sig.bm, r.sig.bn, r.sig.bk, r.gm, r.gn) for r in p.regions] \
        == [(16, 256, 64, 1, 197)]
    assert plan_mod.build_plan(32, 8192, 2048, "H", "NN").num_kernel_calls == 1
    assert plan_mod.build_plan(21, 50, 21, "S", "NN").regions[0].sig.bk == 32


def test_transposition_is_a_view_not_a_copy():
    x = torch.arange(12.0).reshape(3, 4)
    v = templates.op(x, "T")
    assert v.data_ptr() == x.data_ptr() and v.stride() == (1, 4)
    assert templates.op(x, "N") is x


def test_execute_writes_strided_views_of_one_output():
    """CPU run of a multi-region plan through the plain version, with a
    transposed strided B (the tied-embedding case): equals the oracle."""
    rng = np.random.RandomState(0)
    M, N, K = 33, 300, 70
    a = torch.from_numpy(rng.randn(M, K).astype(np.float32))
    emb = torch.from_numpy(rng.randn(N, K).astype(np.float32))
    p = plan_mod.build_plan(M, N, K, "S", "NN")
    assert p.num_kernel_calls > 1
    out = plan_mod.execute(p, a, emb.T)
    want = a.double() @ emb.double().T
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-4)


def test_build_kernel_callable_runs_its_signature():
    """kernelgen.build_kernel: one callable per signature, cached, that
    runs alpha*op(A)@op(B) + beta*C (on the CPU: the plain version)."""
    sig = kernelgen.kernel_table("D", "TN")[0]
    fn = kernelgen.build_kernel(sig)
    assert fn is kernelgen.build_kernel(sig) and fn.sig == sig
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randn(9, 5))          # stored (K, M)
    b = torch.from_numpy(rng.randn(9, 7))          # stored (K, N)
    c = torch.from_numpy(rng.randn(5, 7))
    out = fn(a, b, c, alpha=2.0, beta=-1.0)
    np.testing.assert_allclose(out.numpy(),
                               2.0 * a.numpy().T @ b.numpy() - c.numpy(),
                               rtol=1e-12, atol=1e-12)
