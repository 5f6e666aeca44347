"""The port's grouped GEMMs and MoE serving slice against the JAX package's.

The grouped kernels: the port's wrappers (on the CPU, their plain
versions) against the JAX Pallas kernels in interpret mode, on the same
numpy inputs, at the reference's tolerances
(``tests/test_kernels_other.py:70-100``: rtol 2e-5 / atol 2e-5 batched,
atol 2e-4 ragged, both f32) and, for bf16 (H), one bf16 rounding of
either side's one cast (rtol 2e-2 as in ``test_torch_gemm.py``).

The MoE layer and serving: JAX initialises moonshot-smoke (2 layers,
d_model 64, 8 experts top-3, d_expert 64, vocab 512);
``params_from_numpy`` carries those weights into the port.  The JAX side
forces the Pallas batched kernel (interpret mode) with the 2-D matmuls
left to XLA, as its own ``test_moe_through_pallas_batched_gemm`` does; the
port forces every routed GEMM onto its kernel wrappers.  The CUDA kernels
themselves are held against their plain versions on the card by
``chip_smoke.py``.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops, ref as jref
from repro.models import layers as JL, lm as jlm, registry as jregistry
from repro.models.common import PALLAS_INTERPRET
from repro.serve import PagedEngine as JPagedEngine, Request as JRequest
from repro_torch import api, configs, obs
from repro_torch.core import kernelgen
from repro_torch.kernels import grouped_gemm as gg, iaat_gemm, ref
from repro_torch.launch import serve as serve_mod
from repro_torch.models import layers as L, lm, registry
from repro_torch.serve import PagedEngine, Request

ARCH = "moonshot-v1-16b-a3b"
KERNEL = api.Policy(backend="kernel")
AUTO = api.Policy(backend="auto")
LIBRARY = api.named_policy("library")
#: the JAX side: the grouped Pallas kernel forced (interpret mode), 2-D
#: matmuls straight to XLA
JAX_GROUPED = PALLAS_INTERPRET.replace(backend="pallas", iaat=False)

_JNP = {"S": jnp.float32, "H": jnp.bfloat16}
_TORCH = {"S": torch.float32, "H": torch.bfloat16}
#: (rtol, atol): the reference's f32 tolerances; H one bf16 rounding
_TOL_BATCHED = {"S": (2e-5, 2e-5), "H": (2e-2, 2e-2)}
_TOL_RAGGED = {"S": (2e-5, 2e-4), "H": (2e-2, 2e-2)}


def _pair(x, letter):
    return jnp.asarray(x, _JNP[letter]), torch.from_numpy(x).to(
        _TORCH[letter])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol[0], atol=tol[1])


# -- grouped kernels --------------------------------------------------------

@pytest.mark.parametrize("letter", ["S", "H"])
@pytest.mark.parametrize("G,C,K,N", [(4, 24, 96, 56),    # the reference's
                                     (3, 30, 70, 130),   # K tail, N overhang
                                     (1, 1, 21, 200),
                                     (2, 8, 128, 64)])
def test_batched_gemm_matches_jax(letter, G, C, K, N):
    rng = np.random.RandomState(G * 1000 + C + K + N)
    jx, tx = _pair(rng.randn(G, C, K).astype(np.float32), letter)
    jw, tw = _pair(rng.randn(G, K, N).astype(np.float32), letter)
    want = jops.batched_gemm(jx, jw, interpret=True)
    got = gg.batched_gemm(tx, tw)
    assert got.dtype == _TORCH[letter] and tuple(got.shape) == (G, C, N)
    _close(got, want, _TOL_BATCHED[letter])
    for pol in (KERNEL, AUTO, LIBRARY):
        _close(api.batched_gemm(tx, tw, policy=pol), want,
               _TOL_BATCHED[letter])


def _ragged_inputs(rng, sizes, K, N, bm):
    """The reference property test's layout: each group padded to a
    multiple of bm (at least one tile, so an empty group is one zero
    tile), padding zeroed; plus a group with no tile at all."""
    G = len(sizes) + 1
    w = rng.randn(G, K, N).astype(np.float32)
    xs, gids, sizes_padded = [], [], []
    for g, s in enumerate(sizes):
        p = max(-(s // -bm) * bm, bm)
        blk = rng.randn(p, K).astype(np.float32)
        blk[s:] = 0
        xs.append(blk)
        gids += [g] * (p // bm)
        sizes_padded.append(p)
    sizes_padded.append(0)                       # group G-1: no rows
    return (np.concatenate(xs), w, np.array(gids, np.int32),
            np.array(sizes_padded, np.int32))


@pytest.mark.parametrize("letter", ["S", "H"])
@pytest.mark.parametrize("sizes,K,N,bm", [([0, 5, 17, 0, 40], 32, 48, 8),
                                          ([3, 0, 9], 96, 128, 8),
                                          ([20, 0, 33, 1], 70, 130, 16)])
def test_ragged_gemm_matches_jax(letter, sizes, K, N, bm):
    """Empty groups, K tails, N overhangs, and the row tile bm = 8 under
    the Hopper row grain of 16 (the kernel masks the tile's rows)."""
    rng = np.random.RandomState(sum(sizes) + K)
    x, w, gids, sizes_padded = _ragged_inputs(rng, sizes, K, N, bm)
    jx, tx = _pair(x, letter)
    jw, tw = _pair(w, letter)
    want = jops.ragged_gemm(jx, jw, jnp.asarray(gids), bm=bm, interpret=True)
    tg = torch.from_numpy(gids)
    got = gg.ragged_gemm(tx, tw, tg, bm=bm)
    _close(got, want, _TOL_RAGGED[letter])
    for pol in (KERNEL, AUTO, LIBRARY):
        _close(api.ragged_gemm(tx, tw, tg, bm=bm, policy=pol), want,
               _TOL_RAGGED[letter])
    if letter == "S":
        # both packages' grouped oracles agree with the kernels
        sp = torch.from_numpy(sizes_padded)
        _close(ref.ref_grouped_gemm(tx, tw, sp),
               jref.ref_grouped_gemm(jx, jw, jnp.asarray(sizes_padded)),
               _TOL_RAGGED["S"])
        _close(got, jref.ref_grouped_gemm(jx, jw, jnp.asarray(sizes_padded)),
               _TOL_RAGGED["S"])


def test_ragged_gemm_refuses_bad_ids_and_padding():
    x, w = torch.randn(16, 8), torch.randn(3, 8, 4)
    for ids in (torch.tensor([0, 3]), torch.tensor([-1, 0])):
        with pytest.raises(ValueError, match="tile_group_ids"):
            gg.ragged_gemm(x, w, ids, bm=8)
    with pytest.raises(ValueError, match="padded"):
        gg.ragged_gemm(x[:12], w, torch.tensor([0]), bm=8)
    with pytest.raises(ValueError, match="tile_group_ids"):
        gg.ragged_gemm(x, w, torch.tensor([0]), bm=8)


# -- routing ------------------------------------------------------------------

def test_pick_blocks_is_always_a_table_instance():
    """Per-dimension maxima can name a pair the Hopper table dropped
    ((128, 256) for S/H, more for D); pick_blocks chooses whole
    instances."""
    sizes = (1, 8, 30, 64, 100, 128, 300, 1408, 4096)
    for letter in kernelgen.KERNEL_LETTERS:
        dtype = {"S": torch.float32, "D": torch.float64,
                 "H": torch.bfloat16}[letter]
        table = {(s.bm, s.bn, s.bk)
                 for s in kernelgen.kernel_table(letter, "NN")}
        for C, K, N in itertools.product(sizes, sizes, sizes):
            assert gg.pick_blocks(C, K, N, dtype) in table, (letter, C, K, N)
    # the per-dimension maxima (128, 256) do not exist: a whole instance
    assert gg.pick_blocks(128, 2048, 4096, torch.float32) == (128, 128, 64)
    assert gg.pick_blocks(128, 2048, 4096, torch.float64) == (128, 64, 64)
    # moonshot's decode problems: 8 rows a group, one 16-row block
    assert gg.pick_blocks(8, 2048, 1408, torch.bfloat16) == (16, 256, 64)
    assert gg.pick_blocks(8, 1408, 2048, torch.bfloat16) == (16, 256, 64)


def test_grouped_routes_auto_forced_and_size_class():
    obs.reset()
    cfg = configs.get_config(ARCH)
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
    for dims in ((E, 8, d, f), (E, 8, f, d)):     # moonshot decode, C = 8
        dec = api.route("batched_gemm", dims, "H", policy=AUTO)
        assert (dec.use_kernel, dec.source) == (True, "analytical")
        assert dec.blocks == (16, 256, 64)
        dec = api.route("batched_gemm", dims, "H", policy=LIBRARY)
        assert (dec.use_kernel, dec.source) == (False, "forced")
    big = (4, 4096, 4096, 4096)
    assert not api.route("batched_gemm", big, "S", policy=AUTO).use_kernel
    dec = api.route("batched_gemm", big, "S", policy=KERNEL)
    assert (dec.use_kernel, dec.source) == (True, "forced")
    # ragged keeps the caller's row tile as the routing unit
    dec = api.route("ragged_gemm", (6, 8, 96, 48), "S", policy=AUTO)
    assert dec.use_kernel and dec.blocks == gg.pick_blocks(
        8, 96, 48, torch.float32)
    # the shape log prices grouped ops by the per-group (C, N, K)
    hist = obs.ROUTES.histogram()
    classes = {k[3] for k in hist if k[0] == "batched_gemm"}
    assert "3-10-11" in classes          # C=8, N=1408, K=2048
    assert obs.ROUTES.kernel_share()[0] >= 4


def test_policy_kernels_family():
    assert KERNEL.use_kernels and AUTO.use_kernels
    assert not LIBRARY.use_kernels
    # the reference's iaat=False grouped run: 2-D to the library, grouped
    # on the kernel
    pol = api.Policy(backend="kernel", iaat=False)
    assert pol.use_kernels
    # ``kernels`` pins the family whatever the backend (the reference's
    # ``Policy.kernels``); empty derives it, as every policy built so far
    for backend in api.BACKENDS:
        assert not api.Policy(backend=backend,
                              kernels="library").use_kernels
        assert api.Policy(backend=backend, kernels="kernel").use_kernels
        assert api.Policy(backend=backend).use_kernels == \
            (backend != "library")
    assert api.named_policy("tuned").kernels == ""
    assert not api.named_policy("auto").replace(
        kernels="library").use_kernels
    with pytest.raises(ValueError, match="kernel family"):
        api.Policy(kernels="xla")


# -- the MoE layer ------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    """(cfg, JAX cfg, JAX model, JAX params, params as numpy) per compute
    dtype and capacity factor."""
    cache = {}

    def get(dtype, capacity_factor=None):
        key = (dtype, capacity_factor)
        if key not in cache:
            jcfg = jconfigs.get_smoke(ARCH)
            cfg = configs.get_smoke(ARCH)
            if capacity_factor is not None:
                jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
                    jcfg.moe, capacity_factor=capacity_factor))
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=capacity_factor))
            jcfg = dataclasses.replace(jcfg, dtype=dtype)
            cfg = dataclasses.replace(cfg, dtype=dtype)
            jmodel = jregistry.build(jcfg)
            jparams = jmodel.init(jax.random.PRNGKey(0))
            tree = jax.tree.map(np.asarray, jparams)
            cache[key] = (cfg, jcfg, jmodel, jparams, tree)
        return cache[key]
    return get


def test_params_from_numpy_carries_moe_weights(smoke):
    cfg, _jcfg, _jm, _jp, tree = smoke("bfloat16")
    p = lm.params_from_numpy(tree, cfg, device="cpu")
    for i, blk in enumerate(p.blocks):
        assert blk.mlp is None and blk.moe is not None
        assert blk.moe.router.dtype == torch.float32
        src = tree["blocks"]["moe"]
        assert torch.equal(blk.moe.router,
                           torch.tensor(src["router"][i]))
        for k in ("w_gate", "w_up", "w_down"):
            w = getattr(blk.moe, k)
            assert w.dtype == torch.bfloat16
            assert tuple(w.shape) == src[k][i].shape
            assert torch.equal(w, torch.tensor(src[k][i]).to(w.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_matches_jax(smoke, dtype):
    """``L.moe`` against the JAX layer with its Pallas batched kernel: f32
    to 1e-4 with identical expert choices and slot maps; bf16 within a few
    bf16 steps of outputs of size O(1), as the paged logits test."""
    cfg, jcfg, _jm, jparams, tree = smoke(dtype)
    tp = lm.params_from_numpy(tree, cfg, device="cpu")
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, cfg.d_model).astype(np.float32)
    jx = jnp.asarray(x, jcfg.compute_dtype)
    tx = torch.from_numpy(x).to(cfg.compute_dtype)
    for layer in range(cfg.n_layers):
        jp = jax.tree.map(lambda a: a[layer], jparams["blocks"]["moe"])
        tpl = tp.blocks[layer].moe
        yj, auxj = JL.moe(jp, jx, JAX_GROUPED, jcfg)
        yt, auxt = L.moe(tpl, tx, KERNEL, cfg)
        got, want = yt.float().numpy(), np.asarray(yj, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            T = x.shape[0] * x.shape[1]
            C = L._capacity(T, cfg.moe)
            jbuf, (jslot, jtop), _ = JL._moe_dispatch(
                jp["router"], jx.reshape(T, -1), jcfg, C)
            tbuf, (tslot, ttop), _ = L._moe_dispatch(
                tpl.router, tx.reshape(T, -1), cfg, C)
            np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
            np.testing.assert_allclose(ttop.numpy(), np.asarray(jtop),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
            probs = jax.nn.softmax(jnp.asarray(x.reshape(T, -1))
                                   @ jp["router"])
            want_e = np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1])
            got_e = L._top_k(torch.softmax(tx.reshape(T, -1) @ tpl.router,
                                           -1), cfg.moe.top_k)[1]
            np.testing.assert_array_equal(got_e.numpy(), want_e)
        else:
            err = np.abs(got - want)
            assert err.max() < 0.1, err.max()
            assert err.mean() < 0.01, err.mean()
        np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-4)


def test_moe_layer_drops_past_capacity(smoke):
    """A capacity factor of 0.25 over 32 tokens (C = 8 slots an expert,
    about 12 pairs an expert on average) drops pairs: they land on the
    sink slot E*C, combine to zero, and both packages agree."""
    cfg, jcfg, _jm, jparams, tree = smoke("float32", 0.25)
    tp = lm.params_from_numpy(tree, cfg, device="cpu")
    x = np.random.RandomState(4).randn(1, 32, cfg.d_model).astype(
        np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"])
    T, C = 32, L._capacity(32, cfg.moe)
    assert C == 8
    _b, (slot, _p), _a = L._moe_dispatch(
        tp.blocks[0].moe.router, torch.from_numpy(x[0]), cfg, C)
    assert (slot == cfg.moe.num_experts * C).any()
    yj, _ = JL.moe(jp, jnp.asarray(x), JAX_GROUPED, jcfg)
    yt, _ = L.moe(tp.blocks[0].moe, torch.from_numpy(x), KERNEL, cfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4,
                               atol=1e-4)


def test_cpu_moe_launches_nothing(smoke):
    cfg, _jcfg, _jm, _jp, tree = smoke("float32")
    tp = lm.params_from_numpy(tree, cfg, device="cpu")
    gg.reset_launch_count()
    iaat_gemm.reset_launch_count()
    L.moe(tp.blocks[0].moe, torch.randn(2, 4, cfg.d_model), KERNEL, cfg)
    assert gg.launch_count("batched_gemm") == 0
    assert gg.launch_count("ragged_gemm") == 0
    assert iaat_gemm.launch_count() == 0


# -- serving ------------------------------------------------------------------

def _run_both(smoke, dtype):
    """A recompute-resume prefill chunk (rows past n_prompt; the padded
    tail routes and takes capacity), a fresh prefill in the other slot,
    then two decode steps over both slots, on both packages."""
    cfg, jcfg, _jm, jparams, tree = smoke(dtype)
    tparams = lm.params_from_numpy(tree, cfg, device="cpu")
    rng = np.random.RandomState(0)
    BS, nblocks, slots, C = 8, 9, 2, 16
    jps = jlm.init_paged_state(jcfg, nblocks, BS, slots, jcfg.compute_dtype)
    tps = lm.init_paged_state(cfg, nblocks, BS, slots, cfg.compute_dtype,
                              device="cpu")
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    out = []
    for slot, (n, n_prompt) in enumerate(((11, 7), (5, 5))):
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = rng.randint(0, cfg.vocab, n)
        jl, jps = jlm.paged_prefill(
            jparams, jcfg, JAX_GROUPED, jnp.asarray(toks), jps,
            jnp.asarray(tables[slot:slot + 1]), jnp.asarray([0], jnp.int32),
            slot, n, n_prompt)
        tl = lm.paged_prefill(
            tparams, cfg, KERNEL, torch.from_numpy(toks).long(), tps,
            torch.from_numpy(tables[slot:slot + 1]).long(),
            torch.tensor([0]), slot, n, n_prompt)
        out.append((tl[0, :n], np.asarray(jl, np.float32)[0, :n]))
    pos = np.array([11, 5], np.int32)
    for _ in range(2):
        toks = rng.randint(0, cfg.vocab, (slots, 1)).astype(np.int32)
        jl, jps = jlm.paged_decode(
            jparams, jcfg, JAX_GROUPED, jnp.asarray(toks), jps,
            jnp.asarray(tables), jnp.asarray(pos), jnp.ones((slots,), bool))
        tl = lm.paged_decode(tparams, cfg, KERNEL,
                             torch.from_numpy(toks).long(), tps,
                             torch.from_numpy(tables).long(),
                             torch.from_numpy(pos).long())
        out.append((tl, np.asarray(jl, np.float32)))
        pos = pos + 1
    return out


def test_moe_paged_logits_match_jax_f32(smoke):
    for got, want in _run_both(smoke, "float32"):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-4,
                                   atol=1e-4)


def test_moe_paged_logits_match_jax_bf16(smoke):
    """As the olmo test: a few bf16 steps on logits of size O(1)."""
    for got, want in _run_both(smoke, "bfloat16"):
        err = np.abs(got.float().numpy() - want)
        assert err.max() < 0.1, err.max()
        assert err.mean() < 0.01, err.mean()


def _serve_pair(smoke, dtype, prompts, maxnew, capacity_factor=None, **kw):
    cfg, jcfg, jmodel, jparams, tree = smoke(dtype, capacity_factor)
    je = JPagedEngine(jmodel, jparams, JAX_GROUPED, eos=-1, **kw)
    te = PagedEngine(registry.build(cfg),
                     lm.params_from_numpy(tree, cfg, device="cpu"), KERNEL,
                     eos=-1, device="cpu", **kw)
    for rid, (p, mn) in enumerate(zip(prompts, maxnew)):
        je.submit(JRequest(rid, p.astype(np.int32), max_new=mn))
        te.submit(Request(rid, p.astype(np.int64), max_new=mn))
    return te.run(), je.run(), te


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_engine_tokens_match_jax_engine(smoke, dtype):
    """Temperature 0, 4 requests of mixed lengths on 2 slots (mid-flight
    admission, chunked prefill, inactive decode rows that still route):
    the same tokens as the JAX PagedEngine."""
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 512, n) for n in (5, 9, 3, 17)]
    got, want, te = _serve_pair(smoke, dtype, prompts, [6, 5, 6, 3],
                                slots=2, max_len=64, block_size=8, chunk=8)
    assert got == want
    assert te.cache.blocks_in_use == 0


def test_moe_engine_tokens_match_jax_engine_with_drops(smoke):
    """Capacity factor 0.25 with 32-token prefill chunks: pairs drop in
    prefill (C = 8 slots an expert for ~12 pairs), so capacity couples
    the rows of a chunk, padding included; the tokens stay identical."""
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 512, n) for n in (20, 7, 29)]
    got, want, _te = _serve_pair(smoke, "float32", prompts, [5, 6, 4],
                                 capacity_factor=0.25, slots=2, max_len=64,
                                 block_size=8, chunk=32)
    assert got == want


def test_serve_launcher_runs_moonshot_smoke_on_the_cpu():
    r = serve_mod.serve(ARCH, smoke=True, requests=2, max_new=3,
                        device="cpu", backend="kernel")
    assert r["tokens"] == 6
    assert r["cfg"].family == "moe"
    assert all(p.device.type == "cpu" for p in r["params"].parameters())
