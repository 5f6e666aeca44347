"""The grouped kernels' paths, split of K and tensor-core arithmetic, on the CPU.

The CUDA kernels (``csrc/grouped_gemm.cu``) choose a load path from the
operands' strides, cut K into slices when two or more slices of their
grid fit one block an SM, and multiply bf16 on the tensor cores with the
operands swapped (out^T = w^T x^T, ``mma.sync`` m16n8k16).  None of that
runs here, so each piece is checked as what the CPU can see:

* the path and the split as arithmetic on shapes and strides
  (``grouped_gemm.load_path``, ``launch_plan``, ``plan.grouped_slices``);
* the split's ordered slice sum, emulated in plain torch, against the
  JAX package's grouped kernels (Pallas, interpret mode, as its own tests
  run them) on the same numpy inputs.  Tolerances, on max|got - want|
  over max|want|, as ``chip_smoke.py`` measures the kernels: S 1e-5 (the
  card's: f32 sums of the same exact products in other orders, over K up
  to 1408, where the reference's elementwise 2e-5 for K <= 96 does not
  hold for either side); H 8e-3 (the card's: each side rounds its f32
  sum once to bf16, 2^-8 relative); D 1e-6 against JAX, because the JAX
  kernel keeps an f32 scratch for every dtype, and 1e-12 against numpy's
  f64 product, the card's D tolerance;
* the swapped mma arithmetic (bf16 products, exact in f32, summed in f32
  one k16 step at a time, each slice apart, the result transposed and
  cast once), emulated in plain torch, against ``batched_gemm_plain`` /
  ``ragged_gemm_plain`` at the card's H tolerance, 8e-3 of the largest
  value (``chip_smoke.py`` TOL: both take f32 sums of the same exact
  products in other orders and round once to bf16, 2^-8 relative);
* the launch's C call, with the built library stubbed out: the entry of
  the chosen path, its arguments, the workspace and tickets of a split,
  and the per-path counts.

The kernels themselves are held against their plain versions on the card
by ``chip_smoke.py``.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import kernelgen, plan as plan_mod, vmem
from repro_torch.kernels import grouped_gemm as gg, iaat_gemm

jax.config.update("jax_enable_x64", True)

_NP = {"S": np.float32, "D": np.float64, "H": np.float32}
_JNP = {"S": jnp.float32, "D": jnp.float64, "H": jnp.bfloat16}
_TORCH = {"S": torch.float32, "D": torch.float64, "H": torch.bfloat16}
#: max|got - want| / max|want| against the JAX kernels, and for D against
#: numpy's f64 product (module docstring)
_REL = {"S": 1e-5, "H": 8e-3, "D": 1e-6}
_D_VS_F64 = 1e-12
_H_REL = _REL["H"]
MIN = plan_mod.MIN_SLICE_STEPS
BF = torch.bfloat16

#: moonshot-v1-16b-a3b's expert GEMMs at decode: (K, N) of gate/up, down
MOONSHOT = ((2048, 1408), (1408, 2048))


# -- the path ---------------------------------------------------------------

@pytest.mark.parametrize("dtype,K,N,want", [
    (BF, 2048, 1408, "ring"),          # moonshot gate/up
    (BF, 1408, 2048, "ring"),          # moonshot down
    (BF, 70, 1408, "scalar"),          # x rows of 140 bytes
    (BF, 2048, 300, "scalar"),         # w rows of 600 bytes
    (BF, 64, 8, "ring"),               # one 16-byte chunk a row
    (torch.float32, 70, 64, "scalar"),  # 280-byte rows
    (torch.float32, 68, 132, "ring"),
    (torch.float64, 70, 130, "ring"),  # 560- and 1040-byte rows
    (torch.float64, 3, 2, "scalar"),
])
def test_load_path_follows_dtype_and_strides(dtype, K, N, want):
    x = torch.zeros((3, 9, K), dtype=dtype)
    w = torch.zeros((3, K, N), dtype=dtype)
    assert gg.load_path(x, w) == want
    assert gg.load_path(x.reshape(27, K), w) == want        # ragged rows
    assert gg.launch_plan(x, w, (16, 64, 32))[0] == want


def test_load_path_takes_the_scalar_path_for_views_off_the_ring():
    """Strided columns, a 2-byte offset, w read along K (a transposed
    view), a group stride that breaks the 16-byte rule: scalar; a view of
    whole aligned rows and a size-one dim of any stride: ring."""
    x = torch.zeros((4, 8, 2048), dtype=BF)
    w = torch.zeros((4, 2048, 1408), dtype=BF)
    assert gg.load_path(x, w) == "ring"
    assert gg.load_path(x[:, :, ::2], w[:, ::2]) == "scalar"
    assert gg.load_path(x[:, :, 1:], w[:, 1:]) == "scalar"
    assert gg.load_path(x, torch.zeros((4, 1408, 2048),
                                       dtype=BF).transpose(1, 2)) == "scalar"
    assert gg.load_path(x, w[:, :, 8:]) == "ring"            # 16-byte offset
    assert gg.load_path(x, w[:, :, 4:]) == "scalar"          # 8-byte offset
    odd = torch.zeros((4 * 2049 * 8,), dtype=BF)
    xg = odd.as_strided((4, 8, 2048), (8 * 2049 + 1, 2048, 1))
    assert gg.load_path(xg, w) == "scalar"                   # group stride
    assert gg.load_path(torch.zeros((1, 1, 2048), dtype=BF).as_strided(
        (1, 1, 2048), (7, 3, 1)), w[:1]) == "ring"


# -- the split rule ---------------------------------------------------------

@pytest.mark.parametrize("blocks", [1, 6, 8, 20, 36, 48, 65, 66, 67, 96,
                                    120, 132, 133, 160, 264, 384, 512])
@pytest.mark.parametrize("K,bk", [(64, 64), (128, 32), (200, 64),
                                  (1408, 64), (2048, 64), (2085, 32)])
def test_grouped_slices_keep_one_block_an_sm(blocks, K, bk):
    """More than one slice exactly when two slices of the grid fit one
    block an SM (132) and K has the steps for two slices of
    MIN_SLICE_STEPS; then the most slices that stay within 132 blocks,
    unless K runs out first.  Not the resident blocks of the IAAT rule:
    on the card about 130 grouped blocks already fill the memory
    (PERF.md §6, PR 18), so the rule has no resident-blocks input."""
    s = plan_mod.grouped_slices(blocks, K, bk)
    steps = -(-K // bk)
    assert s >= 1
    assert (s > 1) == (2 * blocks <= vmem.NUM_SMS and steps >= 2 * MIN)
    if s > 1:
        assert blocks * s <= vmem.NUM_SMS
        assert min(e - b for b, e in plan_mod.slice_steps(K, bk, s)) >= MIN
        assert blocks * (s + 1) > vmem.NUM_SMS or s == steps // MIN


def _meta(*shape):
    return torch.empty(shape, dtype=BF, device="meta")


def test_moonshot_decode_takes_the_ring_and_splits_only_one_token():
    """moonshot's decode expert GEMMs at full width: batched (64 groups of
    C = 8: 384 and 512 blocks) and the dropless ragged layout of 4 tokens
    (20 tiles of 8: 120 and 160 blocks) hold enough blocks to fill the
    memory and stay whole; one token's ragged layout (6 tiles: 36 and 48
    blocks) is cut into 3 and 2 slices.  All on the ring, with three
    stages at two blocks an SM."""
    want = {(2048, 1408): (1, 1, 3), (1408, 2048): (1, 1, 2)}
    for K, N in MOONSHOT:
        blocks = gg.pick_blocks(8, K, N, BF)
        assert blocks == (16, 256, 64)
        stage = _grouped_stage(kernelgen.KernelSig("H", "NN", *blocks), BF)
        assert (stage, vmem.RING_BUDGET // stage) == (36096, 3)
        w = _meta(64, K, N)
        for x, tile, sl in ((_meta(64, 8, K), None, want[(K, N)][0]),
                            (_meta(160, K), 8, want[(K, N)][1]),
                            (_meta(48, K), 8, want[(K, N)][2])):
            assert gg.launch_plan(x, w, blocks, tile) == ("ring", sl)


def _grouped_stage(s, dt):
    """One stage of the grouped ring (tile.cuh Ring<.., false, true>): x
    as bm rows of bk and w as bk rows of bn only, rows padded by 16
    bytes."""
    item = vmem.itemsize(dt)
    p = 16 // item
    return (s.bm * (s.bk + p) + s.bk * (s.bn + p)) * item


@pytest.mark.parametrize("letter", kernelgen.KERNEL_LETTERS)
def test_grouped_ring_is_sized_for_w_along_n(letter):
    """The grouped ring stages w as bk rows of bn only: never more bytes a
    stage than the IAAT ring's room for both orientations
    (vmem.ring_stage_bytes), so as many stages as fit two blocks an SM
    (at most 3) are at least the IAAT ring's, within 227 KB."""
    dt = _TORCH[letter]
    grew = []
    for s in kernelgen.kernel_table(letter, "NN"):
        both = s.footprint()
        stage = _grouped_stage(s, dt)
        stages = max(1, min(vmem.RING_STAGES_MAX, vmem.RING_BUDGET // stage))
        assert stage <= both.stage_bytes and stages >= both.stages
        assert stages * stage <= vmem.SMEM_OPTIN_BYTES
        grew += [(s.bm, s.bn, s.bk)] * (stages > both.stages)
    assert grew == {"H": [(16, 256, 64), (32, 256, 64)],
                    "S": [(16, 128, 64), (16, 256, 32), (32, 256, 32)],
                    "D": [(16, 128, 32)]}[letter]


def test_the_2d_split_rule_is_not_the_grouped_one():
    """The IAAT kernel's k_slices keeps its own rule (at least two slices
    under 132 blocks, up to a wave of resident blocks): at 120 blocks it
    takes two where the grouped rule takes one; at 8 (olmo's q/k/v/o)
    both take sixteen, K's limit."""
    assert plan_mod.k_slices(1, 160, 1408, 64, 2) == \
        plan_mod.grouped_slices(160, 1408, 64) == 1
    assert plan_mod.k_slices(1, 120, 2048, 64, 2) == 2
    assert plan_mod.grouped_slices(120, 2048, 64) == 1
    assert plan_mod.k_slices(1, 8, 2048, 64, 2) == \
        plan_mod.grouped_slices(8, 2048, 64) == 16


# -- the split against JAX --------------------------------------------------

def _split_sum(x, w, bk, slices, acc):
    """x (R, K) @ w (K, N) as the kernel sums a split: each slice's bk
    steps in the accumulator type, the slices added in slice order."""
    total = None
    for s0, s1 in plan_mod.slice_steps(x.shape[1], bk, slices):
        k0, k1 = s0 * bk, min(x.shape[1], s1 * bk)
        part = x[:, k0:k1].to(acc) @ w[k0:k1].to(acc)
        total = part if total is None else total + part
    return total


def _batched_split(x, w, blocks, slices):
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    return torch.stack([_split_sum(x[g], w[g], blocks[2], slices, acc)
                        for g in range(x.shape[0])]).to(x.dtype)


def _ragged_split(x, w, ids, bm, blocks, slices):
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    rows = [_split_sum(x[t * bm:(t + 1) * bm], w[int(g)], blocks[2],
                       slices, acc) for t, g in enumerate(ids.tolist())]
    return torch.cat(rows).to(x.dtype)


def _check(letter, got, want, exact):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= _REL[letter] * scale
    if letter == "D":
        assert np.abs(got - exact).max() <= _D_VS_F64 * scale


@pytest.mark.parametrize("letter", ["S", "D", "H"])
@pytest.mark.parametrize("G,C,K,N", [(1, 8, 1408, 192),   # split, decode C
                                     (3, 9, 700, 130),    # K tail 700 % 64
                                     (2, 30, 300, 64)])
def test_batched_split_sum_matches_jax(letter, G, C, K, N):
    rng = np.random.RandomState(G * 1000 + C + K)
    x = rng.randn(G, C, K).astype(_NP[letter])
    w = rng.randn(G, K, N).astype(_NP[letter])
    tx, tw = (torch.from_numpy(a).to(_TORCH[letter]) for a in (x, w))
    blocks = gg.pick_blocks(C, K, N, tx.dtype)
    path, slices = gg.launch_plan(tx, tw, blocks)
    assert slices > 1
    want = jops.batched_gemm(jnp.asarray(x, _JNP[letter]),
                             jnp.asarray(w, _JNP[letter]), interpret=True)
    got = _batched_split(tx, tw, blocks, slices)
    assert got.dtype == _TORCH[letter] and tuple(got.shape) == (G, C, N)
    exact = np.einsum("gck,gkn->gcn", x.astype(np.float64), w)
    _check(letter, got, want, exact)
    # and the plain version the CPU wrapper runs computes the same
    _check(letter, gg.batched_gemm(tx, tw), want, exact)


def _ragged_np(rng, sizes, K, N, bm, dtype):
    """Groups padded to whole tiles of ``bm`` (zeros), one tile for an
    empty group; one more group with no tile."""
    w = rng.randn(len(sizes) + 1, K, N).astype(dtype)
    xs, ids = [], []
    for g, s in enumerate(sizes):
        p = max(-(s // -bm) * bm, bm)
        blk = rng.randn(p, K).astype(dtype)
        blk[s:] = 0
        xs.append(blk)
        ids += [g] * (p // bm)
    return np.concatenate(xs), w, np.array(ids, np.int32)


@pytest.mark.parametrize("letter", ["S", "D", "H"])
@pytest.mark.parametrize("sizes,K,N,bm", [([0, 5, 17, 0, 3], 1408, 256, 8),
                                          ([9, 0, 2], 700, 130, 16)])
def test_ragged_split_sum_matches_jax(letter, sizes, K, N, bm):
    rng = np.random.RandomState(sum(sizes) + K + bm)
    x, w, ids = _ragged_np(rng, sizes, K, N, bm, _NP[letter])
    tx, tw = (torch.from_numpy(a).to(_TORCH[letter]) for a in (x, w))
    tid = torch.from_numpy(ids)
    blocks = gg.pick_blocks(bm, K, N, tx.dtype)
    _, slices = gg.launch_plan(tx, tw, blocks, tile=bm)
    assert slices > 1
    want = jops.ragged_gemm(jnp.asarray(x, _JNP[letter]),
                            jnp.asarray(w, _JNP[letter]), jnp.asarray(ids),
                            bm=bm, interpret=True)
    exact = np.concatenate([x[t * bm:(t + 1) * bm].astype(np.float64)
                            @ w[g] for t, g in enumerate(ids)])
    _check(letter, _ragged_split(tx, tw, tid, bm, blocks, slices), want,
           exact)
    _check(letter, gg.ragged_gemm(tx, tw, tid, bm=bm), want, exact)


# -- the swapped mma arithmetic --------------------------------------------

def _mma_swapped(x, w, bk, slices):
    """x (R, K) @ w (K, N) in bf16 as ring_mma_product computes it:
    out^T = w^T x^T, one m16n8k16 step at a time, bf16 products exact in
    f32 and f32 sums, the K tail zero-filled (a shorter last step sums
    the same), each slice apart, the slices added in order; transposed
    back and cast once."""
    K = x.shape[1]
    total = None
    for s0, s1 in plan_mod.slice_steps(K, bk, slices):
        acc = torch.zeros((w.shape[1], x.shape[0]), dtype=torch.float32)
        for k0 in range(s0 * bk, min(K, s1 * bk), 16):
            k1 = min(k0 + 16, K)
            acc += w[k0:k1].float().T @ x[:, k0:k1].float().T
        total = acc if total is None else total + acc
    return total.T.to(BF)


def _rel(got, want):
    d = (got.double() - want.double()).abs().max().item()
    return d / max(want.double().abs().max().item(), 1e-30)


@pytest.mark.parametrize("G,C,K,N", [(4, 8, 2048, 1408),   # moonshot gate
                                     (4, 8, 1408, 2048),   # and down
                                     (2, 1, 256, 64),
                                     (3, 9, 70, 136),
                                     (2, 16, 512, 192),
                                     (1, 30, 1408, 256)])
def test_mma_arithmetic_matches_plain_batched(G, C, K, N):
    rng = np.random.RandomState(C * 7 + K)
    x = torch.from_numpy(rng.randn(G, C, K).astype(np.float32)).to(BF)
    w = torch.from_numpy((rng.randn(G, K, N) / np.sqrt(K)).astype(
        np.float32)).to(BF)
    blocks = gg.pick_blocks(C, K, N, BF)
    _, slices = gg.launch_plan(x, w, blocks)
    got = torch.stack([_mma_swapped(x[g], w[g], blocks[2], slices)
                       for g in range(G)])
    assert _rel(got, gg.batched_gemm_plain(x, w)) <= _H_REL


@pytest.mark.parametrize("sizes,K,N,bm", [([0, 5, 17, 0, 8, 3], 2048, 1408,
                                           8),
                                          ([20, 0, 33, 1], 512, 192, 16),
                                          ([130, 7], 256, 64, 128)])
def test_mma_arithmetic_matches_plain_ragged(sizes, K, N, bm):
    rng = np.random.RandomState(sum(sizes) + bm)
    x, w, ids = _ragged_np(rng, sizes, K, N, bm, np.float32)
    x = torch.from_numpy(x).to(BF)
    w = (torch.from_numpy(w) / np.sqrt(K)).to(BF)
    tid = torch.from_numpy(ids)
    blocks = gg.pick_blocks(bm, K, N, BF)
    _, slices = gg.launch_plan(x, w, blocks, tile=bm)
    got = torch.cat([_mma_swapped(x[t * bm:(t + 1) * bm], w[int(g)],
                                  blocks[2], slices)
                     for t, g in enumerate(ids.tolist())])
    assert _rel(got, gg.ragged_gemm_plain(x, w, tid, bm)) <= _H_REL


def test_mma_warp_layout_covers_every_h_instance():
    """tile.cuh MmaLayout: 8 warps as WN strips of MT m16 tiles across bn
    and WM strips of NF n8 fragments across bm; a thread's accumulators
    acc[2 NF][2 MT] at (mma_row(i), mma_col(j)) hold every (row, column)
    of the block once, and no more of them than the table's cap."""
    for s in kernelgen.kernel_table("H", "NN"):
        wn = min(s.bn // 16, 8)
        wm = 8 // wn
        mt, nf = s.bn // (16 * wn), s.bm // (8 * wm)
        assert wn * wm == 8 and mt * 16 * wn == s.bn and \
            nf * 8 * wm == s.bm and nf >= 1
        assert 2 * nf * 2 * mt == s.bm * s.bn // vmem.NTHREADS <= \
            vmem.ACC_REG_CAP
        held = set()
        for t in range(vmem.NTHREADS):
            warp, lane = divmod(t, 32)
            for i, j in itertools.product(range(2 * nf), range(2 * mt)):
                m = (warp // wn) * nf * 8 + (i >> 1) * 8 + (t % 4) * 2 + \
                    (i & 1)
                n = (warp % wn) * mt * 16 + (j >> 1) * 16 + lane // 4 + \
                    (j & 1) * 8
                held.add((m, n))
        assert held == set(itertools.product(range(s.bm), range(s.bn)))


# -- the launch, with the library stubbed out -------------------------------

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
    from repro_torch.kernels import build
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda idx: 7, raising=False)
    gg.reset_launch_count()
    yield lib
    gg.reset_launch_count()


@pytest.mark.parametrize("letter,K,path", [("H", 2048, "ring"),
                                           ("H", 2085, "scalar"),
                                           ("S", 2048, "ring"),
                                           ("D", 2085, "scalar")])
@pytest.mark.parametrize("slices", [None, 1, 3])
def test_batched_launch_marshals_path_slices_and_workspace(
        fake_lib, letter, K, path, slices):
    """The C call of a batched launch on CPU tensors: the entry of the
    path the strides choose, the 23 arguments of its C signature, the
    split (the rule's, or an override) with a workspace and the ticket
    array exactly when K is cut, and the per-path counts."""
    dt = _TORCH[letter]
    G, C, N = 2, 8, 200
    x, w = torch.zeros((G, C, K), dtype=dt), torch.zeros((G, K, N), dtype=dt)
    blocks = (16, 64, 64)
    rule = gg.launch_plan(x, w, blocks)[1]
    assert rule > 1                              # 8 blocks: a split
    out = gg._launch_batched(x, w, blocks, slices=slices)
    name, args = fake_lib.calls[-1]
    sl = slices or rule
    assert name == f"batched_gemm_{path}_{letter}" and len(args) == 23
    assert args[:3] == blocks and args[15:19] == (G, C, N, K)
    assert args[4:7] == x.stride() and args[8:11] == w.stride()
    assert args[19] == sl and args[-1] == 7
    assert (args[20] is None) == (args[21] is None) == (sl == 1)
    assert out.shape == (G, C, N) and out.dtype == dt
    assert gg.launch_count("batched_gemm") == 1
    assert gg.path_count(path) == 1
    assert gg.path_count("ring" if path == "scalar" else "scalar") == 0
    assert gg.path_count("split") == (sl > 1)
    assert gg.path_count("mma") == (path == "ring" and letter == "H")


@pytest.mark.parametrize("bm,K", [(8, 2048), (8, 70), (16, 1408),
                                  (128, 256)])
def test_ragged_launch_marshals_path_slices_and_workspace(fake_lib,
                                                         monkeypatch, bm, K):
    """The ragged C call: 22 arguments, the row tile and tile count, the
    ids as int32, the rule's slices with a (slices, T, N) workspace."""
    T, N = 4 * bm, 1408
    x = torch.zeros((T, K), dtype=BF)
    w = torch.zeros((3, K, N), dtype=BF)
    ids = torch.tensor([0, 2, 2, 1])
    blocks = gg.pick_blocks(bm, K, N, BF)
    path, sl = gg.launch_plan(x, w, blocks, tile=bm)
    seen = []
    real_split = gg._split

    def split(*a):
        res = real_split(*a)
        seen.append(None if res[0] is None else tuple(res[0].shape))
        return res
    monkeypatch.setattr(gg, "_split", split)
    out = gg._launch_ragged(x, w, ids, bm, blocks)
    name, args = fake_lib.calls[-1]
    assert name == f"ragged_gemm_{path}_H" and len(args) == 22
    assert path == ("scalar" if K == 70 else "ring")
    assert args[:3] == blocks and args[11:13] == (bm, 4)
    assert args[16:19] == (N, K, sl) and args[-1] == 7
    assert seen == [None if sl == 1 else (sl, T, N)]
    assert out.shape == (T, N)
    assert gg.path_count("split") == (sl > 1)
    assert gg.path_count("mma") == (path == "ring")


def test_split_past_the_tickets_or_the_steps_raises(fake_lib):
    """A split grid with more output tiles than the IAAT kernel's ticket
    array, or more slices than K has bk steps (only an override can ask
    for either), raises; nothing launches."""
    x = torch.zeros((64, 8, 128), dtype=BF)
    w = torch.zeros((64, 128, 1408), dtype=BF)
    gg._launch_batched(x, w, (16, 64, 64), slices=1)       # 22 x 64 tiles
    assert len(fake_lib.calls) == 1
    with pytest.raises(ValueError, match="tickets"):
        gg._launch_batched(x, w, (16, 64, 64), slices=2)
    with pytest.raises(ValueError, match="slices"):
        gg._launch_ragged(x[0], w, torch.tensor([0]), 8, (16, 64, 64),
                          slices=3)                         # 2 steps of 64
    assert len(fake_lib.calls) == 1
    assert 22 * 64 > iaat_gemm._TICKETS_LEN
    assert gg.path_count("split") == 0
