"""The IAAT kernel's run-time split of K and its load paths, on the CPU.

The split is a quantity the plan derives (``plan.k_slices``: the region's
grid, K, its kernel's bk and the card's 132 SMs), so its rule is checked
here as arithmetic.  The CUDA kernel sums each K slice into a workspace
and the last block of a tile adds the slices in order; that sum is
emulated here in plain torch (each slice's partial product in the
accumulator type, the slices added in slice order, then the epilogue) and
held against the JAX package's GEMM (Pallas, interpret mode, as its own
tests run it) on the same numpy inputs, at the reference's ``_RTOL``
(``tests/test_kernels_gemm.py:15``), atol = 10 x rtol.  The kernel itself
is held against its plain version on the card by ``chip_smoke.py``.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api
from repro_torch.core import kernelgen, plan as plan_mod, vmem
from repro_torch.kernels import iaat_gemm

jax.config.update("jax_enable_x64", True)

_RTOL = {"S": 2e-5, "D": 1e-12, "H": 2e-2}
_NP = {"S": np.float32, "D": np.float64, "H": np.float32}
_JNP = {"S": jnp.float32, "D": jnp.float64, "H": jnp.bfloat16}
_TORCH = {"S": torch.float32, "D": torch.float64, "H": torch.bfloat16}
#: (M, N, K) of one olmo-1b decode step's projections: q/k/v/o, gate/up,
#: down; the tied unembed (50432 wide) is the fourth routed shape
OLMO_DECODE = ((4, 2048, 2048), (4, 8192, 2048), (4, 2048, 8192))
MIN = plan_mod.MIN_SLICE_STEPS


@pytest.mark.parametrize("gm,gn", [(1, 1), (1, 8), (1, 25), (1, 32),
                                   (2, 65), (1, 132), (1, 197), (32, 16)])
@pytest.mark.parametrize("K,bk", [(64, 64), (128, 32), (200, 64),
                                  (2048, 64), (8192, 64), (2085, 32)])
@pytest.mark.parametrize("resident", [1, 2])
def test_k_slices_fill_the_card_only_when_it_underfills(gm, gn, K, bk,
                                                        resident):
    """More than one slice exactly when the grid underfills the SMs and K
    has the steps for two slices of MIN_SLICE_STEPS; then as many slices
    as keep the grid in one wave of 132 x ``resident`` blocks (at least
    two), unless K runs out first."""
    s = plan_mod.k_slices(gm, gn, K, bk, resident)
    grid, steps = gm * gn, -(-K // bk)
    wave = vmem.NUM_SMS * resident
    assert (s > 1) == (grid < vmem.NUM_SMS and steps >= 2 * MIN)
    if s > 1:
        spans = plan_mod.slice_steps(K, bk, s)
        assert min(e - b for b, e in spans) >= MIN
        assert grid * s <= wave or s == 2                  # one wave
        assert grid * (s + 1) > wave or s == steps // MIN


@pytest.mark.parametrize("K,bk", [(1, 32), (63, 64), (64, 64), (2085, 64),
                                  (8192, 64), (700, 32)])
def test_slices_cover_k_without_gaps_or_empty_slices(K, bk):
    steps = -(-K // bk)
    for slices in range(1, steps + 1):
        spans = plan_mod.slice_steps(K, bk, slices)
        assert len(spans) == slices
        assert spans[0][0] == 0 and spans[-1][1] == steps
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        lens = [e - b for b, e in spans]
        assert min(lens) >= 1 and max(lens) - min(lens) <= 1


def test_decode_shapes_split_and_large_or_small_cubes_do_not():
    """olmo-1b's decode projections (8 or 32 blocks) split K; the tied
    unembed's 197 blocks, forward_train's M = 4096 and the paper's cubes
    up to 80 keep one slice; the complex kernel never splits."""
    for M, N, K in OLMO_DECODE:
        for r in plan_mod.build_plan(M, N, K, "H", "NN").regions:
            assert r.gm * r.gn < vmem.NUM_SMS and r.slices > 1
            # one wave of two blocks an SM, or every slice at 2 steps
            wave = vmem.NUM_SMS * r.sig.footprint().blocks_per_sm
            assert wave == 2 * vmem.NUM_SMS
            assert r.gm * r.gn * r.slices <= wave
            assert r.gm * r.gn * (r.slices + 1) > wave or \
                r.slices == -(-K // r.sig.bk) // MIN
    assert [r.slices for r in plan_mod.build_plan(
        4, 50432, 2048, "H", "NN").regions] == [1]
    for letter in ("H", "S"):
        assert {r.slices for r in plan_mod.build_plan(
            4096, 2048, 2048, letter, "NN").regions} == {1}
    for letter, trans in itertools.product("SDCZ", ("NN", "NT", "TN",
                                                    "TT")):
        for n in range(2, 81, 6):
            p = plan_mod.build_plan(n, n, n, letter, trans)
            assert {r.slices for r in p.regions} == {1}
    p = plan_mod.build_plan(4, 2048, 2048, "C", "NN")
    assert {r.slices for r in p.regions} == {1}


def test_tuned_override_plan_uses_the_same_rule():
    for sig in kernelgen.kernel_table("H", "NN"):
        for M, N, K in OLMO_DECODE + ((30, 50, 21),):
            r, = plan_mod.build_plan(M, N, K, "H", "NN",
                                     override=sig).regions
            assert r.slices == plan_mod.k_slices(
                r.gm, r.gn, K, sig.bk, sig.footprint().blocks_per_sm)


def test_every_real_instance_rings_within_the_budget():
    """Each real instance takes as many ring stages as leave room for two
    blocks on an SM, at most three and at least one (then one block an
    SM, within 227 KB); the complex kernel's ring holds one bk step in
    stages of 16 k rows; the census is the paper's (22 S, 18 D, 22 H, 12
    C, 6 Z)."""
    for letter in kernelgen.TABLE_LETTERS:
        for s in kernelgen.kernel_table(letter, "NN"):
            fp = s.footprint()
            if s.complex_:
                assert fp.stages == s.bk // vmem.CX_RING_K >= 2
                assert fp.ring_bytes == fp.total <= vmem.SMEM_OPTIN_BYTES
                continue
            stage = vmem.ring_stage_bytes(s.bm, s.bn, s.bk, s.real_dtype)
            assert fp.stage_bytes == stage
            assert fp.stages == max(1, min(vmem.RING_STAGES_MAX,
                                           vmem.RING_BUDGET // stage))
            assert fp.ring_bytes <= vmem.SMEM_OPTIN_BYTES
            assert (fp.blocks_per_sm == 2) == (fp.ring_bytes <=
                                               vmem.RING_BUDGET)
            assert fp.blocks_per_sm * (fp.ring_bytes +
                                       vmem.SMEM_BLOCK_RESERVED) <= \
                vmem.SMEM_SM_BYTES
    assert sorted(kernelgen.census()[f"{L}GEMM_NN"] for L in "SDHCZ") == \
        [6, 12, 18, 22, 22]
    # the decode instance: two stages, two blocks an SM
    fp = kernelgen.KernelSig("H", "NN", 16, 256, 64).footprint()
    assert (fp.stages, fp.blocks_per_sm) == (2, 2)


def test_load_mode_follows_the_strides():
    """The ring along N for NN weights, along K for the tied embed.T, the
    scalar path for rows that are not 16-byte aligned, for strided views
    and for A read along M."""
    bf = torch.bfloat16
    x = torch.zeros((4, 2048), dtype=bf)
    w = torch.zeros((2048, 2048), dtype=bf)
    emb = torch.zeros((1000, 2048), dtype=bf)
    assert iaat_gemm.load_mode(x, w) == 1
    assert iaat_gemm.load_mode(x, emb.T) == 2
    assert iaat_gemm.load_mode(x, w[:, 64:1088]) == 1      # a region view
    assert iaat_gemm.load_mode(torch.zeros((4, 2085), dtype=bf), w[:2085]) \
        == 0
    assert iaat_gemm.load_mode(x[:, ::2], w[::2]) == 0
    assert iaat_gemm.load_mode(torch.zeros((2048, 4), dtype=bf).T, w) == 0
    assert iaat_gemm.load_mode(x[:, 1:], w[1:]) == 0         # 2-byte offset
    f64 = torch.zeros((4, 64), dtype=torch.float64)
    assert iaat_gemm.load_mode(f64, torch.zeros((64, 10),
                                                dtype=torch.float64)) == 1


def _split_emulation(a, b, c, alpha, beta, letter, sig, slices):
    """The CUDA kernel's split sum: each slice's K steps summed in the
    accumulator type, the slices added in slice order, then alpha/beta in
    the accumulator type and one cast."""
    acc = sig.acc_dtype
    total = None
    for s0, s1 in plan_mod.slice_steps(a.shape[1], sig.bk, slices):
        k0, k1 = s0 * sig.bk, min(a.shape[1], s1 * sig.bk)
        part = a[:, k0:k1].to(acc) @ b[k0:k1].to(acc)
        total = part if total is None else total + part
    out = alpha * total
    if c is not None:
        out = out + beta * c.to(acc)
    return out.to(_TORCH[letter])


@pytest.mark.parametrize("letter", ["S", "D", "H"])
@pytest.mark.parametrize("M,N,K,beta", [(4, 500, 300, 0.0),
                                        (3, 128, 700, -1.5)])
def test_split_sum_matches_jax(letter, M, N, K, beta):
    rng = np.random.RandomState(M * 1000 + K)
    a = rng.randn(M, K).astype(_NP[letter])
    b = rng.randn(K, N).astype(_NP[letter])
    c = rng.randn(M, N).astype(_NP[letter]) if beta else None
    alpha = 0.75
    p = plan_mod.build_plan(M, N, K, letter, "NN")
    r, = p.regions
    assert r.slices > 1 and r.gm * r.gn == -(-M // r.sig.bm) * -(-N //
                                                                  r.sig.bn)
    with japi.using(backend="pallas", interpret=True):
        want = np.asarray(japi.gemm(
            jnp.asarray(a, _JNP[letter]), jnp.asarray(b, _JNP[letter]),
            None if c is None else jnp.asarray(c, _JNP[letter]), alpha,
            beta), np.float64)
    ta, tb = (torch.from_numpy(x).to(_TORCH[letter]) for x in (a, b))
    tc = None if c is None else torch.from_numpy(c).to(_TORCH[letter])
    tol = _RTOL[letter]
    for got in (_split_emulation(ta, tb, tc, alpha, beta, letter, r.sig,
                                 r.slices),
                api.gemm(ta, tb, tc, alpha, beta,
                         policy=api.Policy(backend="kernel"))):
        assert got.dtype == _TORCH[letter] and got.shape == (M, N)
        np.testing.assert_allclose(got.double().numpy(), want, rtol=tol,
                                   atol=tol * 10)


class _FakeLib:
    """Stands in for the built library: records each C call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("tied,unaligned,want", [
    (False, False, "iaat_gemm_ring_n_H"), (True, False, "iaat_gemm_ring_k_H"),
    (False, True, "iaat_gemm_scalar_H")])
def test_launch_marshals_paths_slices_and_workspace(monkeypatch, tied,
                                                    unaligned, want):
    """The launch's C call on CPU tensors with the library stubbed out:
    the entry of the path the strides choose, the C signature's 24
    arguments, a workspace and the ticket array exactly when K is split,
    and the per-path counts."""
    from repro_torch.kernels import build
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda idx: 7, raising=False)
    iaat_gemm._entry.cache_clear()
    iaat_gemm.reset_launch_count()
    bf = torch.bfloat16
    K = 2085 if unaligned else 2048
    x = torch.zeros((4, K), dtype=bf)
    w = torch.zeros((1000, K), dtype=bf).T if tied else \
        torch.zeros((K, 1000), dtype=bf)
    sig = kernelgen.KernelSig("H", "NN", 16, 256, 64)
    try:
        for slices in (1, 16):
            out = iaat_gemm._launch(sig, x, w, None, 1.0, 0.0, None, slices)
            name, args = lib.calls[-1]
            assert name == want and len(args) == 24
            assert args[:3] == (16, 256, 64) and args[15:18] == (4, 1000, K)
            assert args[20] == slices and args[-1] == 7
            assert (args[21] is None) == (args[22] is None) == (slices == 1)
            assert out.shape == (4, 1000) and out.dtype == bf
    finally:
        iaat_gemm._entry.cache_clear()
    path = "scalar" if unaligned else "ring"
    assert iaat_gemm.path_count(path) == 2
    assert iaat_gemm.path_count("split") == 1
    assert iaat_gemm.launch_count("iaat_gemm") == 2
    iaat_gemm.reset_launch_count()
