"""The port's SSM family (mamba2-smoke) against the JAX package's.

JAX initialises mamba2-smoke (2 layers, d_model 64, d_state 16, head_dim
8, chunk 16, vocab 256); ``params_from_numpy`` carries those weights into
the port, so both sides run the same model.  ``forward_train`` is held
against the reference under both policies: the port's ``library``
(``ref.ref_ssd``) against the reference's ``xla``, and the port's
``kernel`` (on the CPU: the SSD kernel's plain version, and every GEMM's)
against the reference's ``pallas`` in interpret mode.  Serving is held
token for token against the reference's ``PagedEngine`` at f32, and the
reference's slot-state tests (``tests/test_serve_state.py``) are mirrored
against the port's own wave oracle, ``ContinuousBatcher(slots=1)``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.models.common import PALLAS_INTERPRET, XLA
from repro.serve import PagedEngine as JPagedEngine, Request as JRequest
from repro_torch import api, configs, obs
from repro_torch.kernels import ssd
from repro_torch.launch import serve as serve_mod
from repro_torch.models import lm, registry, ssm
from repro_torch.serve import ContinuousBatcher, PagedEngine, Request

ARCH = "mamba2-780m"
KERNEL = api.Policy(backend="kernel")
LIBRARY = api.Policy(backend="library")
#: forward_train logits, port vs reference, over the largest logit: f32
#: takes the same products in other summation orders; bf16 rounds every
#: projection to bf16 in two frameworks, and one rounding step (2^-8)
#: flipped in a layer propagates through the rest
FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def smoke():
    """(port cfg, JAX cfg, JAX model, JAX params, numpy tree) per dtype."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=dtype)
            jmodel = jregistry.build(jcfg)
            jparams = jmodel.init(jax.random.PRNGKey(0))
            tree = jax.tree.map(np.asarray, jparams)
            cfg = dataclasses.replace(configs.get_smoke(ARCH), dtype=dtype)
            cache[dtype] = (cfg, jcfg, jmodel, jparams, tree)
        return cache[dtype]
    return get


def test_config_matches_reference():
    for get in ("get_config", "get_smoke"):
        got = getattr(configs, get)(ARCH)
        want = getattr(jconfigs, get)(ARCH)
        for f in ("name", "family", "n_layers", "d_model", "vocab",
                  "tie_embeddings", "d_inner", "ssm_heads", "vocab_padded"):
            assert getattr(got, f) == getattr(want, f), (get, f)
        assert dataclasses.asdict(got.ssm) == dataclasses.asdict(want.ssm)
    full = configs.get_config(ARCH)
    assert (full.d_inner, full.ssm_heads) == (3072, 48)
    s = full.ssm
    assert 2 * full.d_inner + 2 * s.d_state + full.ssm_heads == 6448


def test_params_from_numpy_carries_jax_weights(smoke):
    cfg, _jcfg, _jm, _jp, tree = smoke("bfloat16")
    p = lm.params_from_numpy(tree, cfg, device="cpu")
    assert len(p.blocks) == cfg.n_layers and p.unembed is None   # tied
    assert p.embed.dtype == torch.bfloat16
    assert torch.equal(p.embed, torch.tensor(tree["embed"]).bfloat16())
    assert p.final_norm.dtype == torch.float32
    want_dtype = {"in_proj": torch.bfloat16, "out_proj": torch.bfloat16,
                  "conv_w": torch.float32, "conv_b": torch.float32,
                  "norm_w": torch.float32, "A_log": torch.float32,
                  "D": torch.float32, "dt_bias": torch.float32}
    for i, blk in enumerate(p.blocks):
        assert blk.ln1.dtype == torch.float32
        assert torch.equal(blk.ln1, torch.tensor(tree["blocks"]["ln1"][i]))
        for k in ssm.PARAMS:
            w = getattr(blk.mixer, k)
            src = tree["blocks"]["mixer"][k][i]
            assert w.dtype == want_dtype[k], k
            assert tuple(w.shape) == src.shape, k
            assert torch.equal(w, torch.tensor(src).to(w.dtype)), k


def test_init_lm_shapes_and_dtypes_match_params_from_numpy(smoke):
    cfg, _jcfg, _jm, _jp, tree = smoke("bfloat16")
    got = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = lm.params_from_numpy(tree, cfg, device="cpu")
    gs, ws = got.state_dict(), want.state_dict()
    assert gs.keys() == ws.keys()
    for k in gs:
        assert (gs[k].shape, gs[k].dtype) == (ws[k].shape, ws[k].dtype), k
    A = -torch.exp(got.blocks[0].mixer.A_log)
    assert (A <= -1).all() and (A >= -16).all()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["library", "kernel"])
def test_forward_train_matches_reference(smoke, dtype, policy):
    """Logits of 2 x 37 tokens (S past two chunks of 16, with a tail)."""
    cfg, _jcfg, jmodel, jparams, tree = smoke(dtype)
    tparams = lm.params_from_numpy(tree, cfg, device="cpu")
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (2, 37))
    jbe = XLA if policy == "library" else PALLAS_INTERPRET
    want, jaux = jmodel.forward_train(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, jbe)
    ssd.reset_launch_count()
    got, aux = registry.build(cfg).forward_train(
        tparams, torch.from_numpy(toks), api.Policy(backend=policy))
    assert got.shape == (2, 37, cfg.vocab_padded)
    assert got.dtype == cfg.compute_dtype
    assert float(aux) == float(jaux) == 0.0
    assert ssd.launch_count() == 0        # the CPU runs the plain version
    assert _rel(got.float(), np.asarray(want, np.float32)) <= FWD_TOL[dtype]


def test_forward_train_policies_agree_and_route_the_ssd(smoke, monkeypatch):
    """Under ``kernel`` every mamba layer calls ``ssd.ssd_scan`` once over
    the whole sequence; under ``library`` none does."""
    cfg, _jcfg, _jm, _jp, tree = smoke("float32")
    tparams = lm.params_from_numpy(tree, cfg, device="cpu")
    calls = []
    orig = ssd.ssd_scan

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)
    monkeypatch.setattr(ssd, "ssd_scan", spy)
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (3, 20)))
    lk, _ = lm.forward_train(tparams, cfg, KERNEL, toks)
    assert calls == [(3, 20, cfg.ssm_heads, cfg.ssm.head_dim)] * cfg.n_layers
    ll, _ = lm.forward_train(tparams, cfg, LIBRARY, toks)
    assert len(calls) == cfg.n_layers
    assert _rel(lk, ll) <= 1e-5


@pytest.mark.parametrize("policy", ["library", "kernel"])
def test_forward_train_of_a_dense_family_matches_reference(policy):
    """The same entry serves the attention families: olmo-smoke (f32,
    2 x 37 tokens) against the reference under both policy pairs, flash
    (on the CPU its plain version) against the Pallas kernel in interpret
    mode under ``kernel``; its aux loss is 0."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("olmo-1b"), dtype="float32")
    jmodel = jregistry.build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(configs.get_smoke("olmo-1b"), dtype="float32")
    tparams = lm.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (2, 37))
    want, jaux = jmodel.forward_train(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
        XLA if policy == "library" else PALLAS_INTERPRET)
    got, aux = registry.build(cfg).forward_train(
        tparams, torch.from_numpy(toks), api.Policy(backend=policy))
    assert got.shape == (2, 37, cfg.vocab_padded)
    assert float(aux) == float(jaux) == 0.0
    assert _rel(got, np.asarray(want, np.float32)) <= FWD_TOL["float32"]


def _prompts(seed, n, lo=2, hi=20):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, int(rng.randint(lo, hi))) for _ in range(n)]


def test_paged_engine_matches_reference(smoke):
    """Four requests through both packages' PagedEngine at f32 (two slots,
    chunk 8: multi-chunk prefill, slot reuse, mid-flight admission)."""
    cfg, _jcfg, jmodel, jparams, tree = smoke("float32")
    tparams = lm.params_from_numpy(tree, cfg, device="cpu")
    prompts = _prompts(0, 4)
    je = JPagedEngine(jmodel, jparams, XLA, slots=2, max_len=64, eos=-1,
                      block_size=8, chunk=8)
    te = PagedEngine(registry.build(cfg), tparams, KERNEL, slots=2,
                     max_len=64, eos=-1, block_size=8, chunk=8, device="cpu")
    for i, p in enumerate(prompts):
        je.submit(JRequest(i, p.astype(np.int32), max_new=6))
        te.submit(Request(i, p.astype(np.int64), max_new=6))
    assert te.run() == je.run()
    assert te.state.bound == 0 and te.state.binds == 4


def test_paged_step_inactive_rows_untouched(smoke):
    """A masked decode step advances only the active slot's carry; the
    other rows stay bitwise as they were (``active`` masking)."""
    cfg, _jcfg, _jm, _jp, tree = smoke("float32")
    tparams = lm.params_from_numpy(tree, cfg, device="cpu")
    ps = lm.init_paged_state(cfg, 4, 8, 3, cfg.compute_dtype, device="cpu")
    tables = torch.zeros((3, 4), dtype=torch.long)
    rng = np.random.RandomState(4)
    for slot in range(3):
        toks = torch.from_numpy(rng.randint(0, 256, (1, 8)))
        lm.paged_prefill(tparams, cfg, KERNEL, toks, ps, tables[:1],
                         torch.tensor([0]), slot, 5, 5)
    before = (ps.conv.clone(), ps.ssm.clone())
    act = torch.tensor([False, True, False])
    lm.paged_decode(tparams, cfg, KERNEL,
                    torch.from_numpy(rng.randint(0, 256, (3, 1))), ps, tables,
                    torch.tensor([5, 5, 5]), act)
    for new, old in zip((ps.conv, ps.ssm), before):
        assert torch.equal(new[:, 0], old[:, 0])
        assert torch.equal(new[:, 2], old[:, 2])
        assert not torch.equal(new[:, 1], old[:, 1])


def _wave_ref(model, params, prompts, maxnew, eos=-1):
    """Single-request reference runs: the wave oracle at slots=1."""
    b = ContinuousBatcher(model, params, KERNEL, slots=1, max_len=64,
                          eos=eos, device="cpu")
    for rid, (p, mn) in enumerate(zip(prompts, maxnew)):
        b.submit(Request(rid, p.astype(np.int64), max_new=mn))
    return b.run()


@pytest.fixture(scope="module")
def port_model():
    cfg = configs.get_smoke(ARCH)
    model = registry.build(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_slot_isolation_random_interleaving(port_model, seed):
    """Random interleavings of admit / decode / budget-evict / preempt
    (pool sized to exhaust) over shared slots: every request's tokens
    equal its single-request wave run (``test_serve_state.py``)."""
    cfg, model, params = port_model
    rng = np.random.RandomState(seed)
    n = 6
    prompts = [rng.randint(0, cfg.vocab, int(rng.randint(2, 20)))
               for _ in range(n)]
    maxnew = [int(rng.randint(2, 9)) for _ in range(n)]
    ref = _wave_ref(model, params, prompts, maxnew)
    e = PagedEngine(model, params, KERNEL, slots=2, max_len=64, eos=-1,
                    block_size=8, chunk=8, num_blocks=6, device="cpu")
    e.submit(Request(0, prompts[0].astype(np.int64), max_new=maxnew[0]))
    for rid in range(1, n):             # admissions land mid-flight
        for _ in range(int(rng.randint(0, 5))):
            e.step()
        e.submit(Request(rid, prompts[rid].astype(np.int64),
                         max_new=maxnew[rid]))
    assert e.run() == ref
    assert e.state.bound == 0 and e.state.binds == e.state.releases
    assert e.cache.blocks_in_use == 0


def test_slot_isolation_eos_evict_and_reuse(port_model):
    """EOS-evicted slots hand their state row to the next request, which
    must start from a zero carry, not the evictee's."""
    cfg, model, params = port_model
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab, p) for p in (4, 6, 9, 5)]
    free = _wave_ref(model, params, prompts, [8, 8, 8, 8])
    eos = free[0][2]                    # a token that WILL appear
    ref = _wave_ref(model, params, prompts, [8, 8, 8, 8], eos=eos)
    assert any(len(v) < 8 for v in ref.values())    # eviction exercised
    e = PagedEngine(model, params, KERNEL, slots=2, max_len=64, eos=eos,
                    block_size=8, chunk=8, device="cpu")
    for rid, p in enumerate(prompts):
        e.submit(Request(rid, p.astype(np.int64), max_new=8))
    assert e.run() == ref
    assert e.state.bound == 0 and e.state.binds == 4


def test_exhaustion_resume_rebuilds_carry(port_model):
    """Block exhaustion preempts a decoding request (its carry row
    released with its blocks); recompute-resume re-prefills prompt +
    generated from a zero row, token-identical to the unpreempted run."""
    cfg, model, params = port_model
    obs.reset()
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab, 7) for _ in range(2)]
    ref = _wave_ref(model, params, prompts, [10, 10])
    e = PagedEngine(model, params, KERNEL, slots=2, max_len=24, eos=-1,
                    block_size=8, chunk=8, num_blocks=4, device="cpu")
    for rid, p in enumerate(prompts):
        e.submit(Request(rid, p.astype(np.int64), max_new=10))
    assert e.run() == ref
    assert obs.counter("serve.preemptions").value > 0
    assert e.state.binds > 2            # at least one resume re-bound
    assert e.state.bound == 0 and e.cache.blocks_in_use == 0


def test_continuous_batcher_one_slot_matches_paged(port_model):
    """The wave engine at slots=1 (exact unbatched generation) and the
    paged engine (4 slots, chunk 16) give the same tokens."""
    cfg, model, params = port_model
    prompts = _prompts(5, 5, 3, 30)
    ref = _wave_ref(model, params, prompts, [7] * 5)
    e = PagedEngine(model, params, KERNEL, slots=4, max_len=64, eos=-1,
                    block_size=16, chunk=16, device="cpu")
    for rid, p in enumerate(prompts):
        e.submit(Request(rid, p.astype(np.int64), max_new=7))
    assert e.run() == ref


def test_launcher_serves_the_ssm_arch():
    r = serve_mod.serve(ARCH, smoke=True, requests=3, max_new=4,
                        device="cpu", backend="kernel")
    assert r["cfg"].family == "ssm"
    assert sorted(r["done"]) == [0, 1, 2]
    assert r["tokens"] == 12
    assert r["decode_steps"] > 0
