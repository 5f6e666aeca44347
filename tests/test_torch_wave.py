"""The port's wave serving path against the JAX package's, on the same
weights.

JAX initialises olmo-smoke (2 layers, d_model 64, 4 heads, vocab 256) and
moonshot-smoke (its MoE sibling); ``params_from_numpy`` carries those
weights into the port.  Under the library policy both sides attend a
whole prompt with ``chunked_mha`` (JAX: forced XLA); under the kernel
policy the JAX side runs its Pallas flash kernel in interpret mode (the
2-D matmuls left to XLA, MoE experts on its Pallas grouped kernel) and
the port runs its flash wrapper, which on the CPU is its plain version.
Tolerances: 1e-4 on f32 logits of size O(1) (summation order only); in
bf16 the two frameworks round at other places, as in
``test_torch_serve.py``: max 0.1 and mean 0.01.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi, configs as jconfigs
from repro.configs.base import AttentionPattern as JAttentionPattern
from repro.models import layers as JL, lm as jlm, registry as jregistry
from repro.models.common import XLA
from repro.serve import ContinuousBatcher as JBatcher, Request as JRequest
from repro_torch import api, configs
from repro_torch.configs.base import AttentionPattern
from repro_torch.models import layers as L, lm, registry
from repro_torch.serve import ContinuousBatcher, PagedEngine, Request

OLMO, MOE = "olmo-1b", "moonshot-v1-16b-a3b"
KERNEL = api.Policy(backend="kernel")
LIBRARY = api.named_policy("library")
#: the JAX side of the kernel policy: Pallas flash (interpret mode) with
#: the 2-D matmuls left to XLA and the MoE experts on the Pallas grouped
#: kernel
JAX_KERNEL = japi.Policy(backend="pallas", kernels="pallas", iaat=False,
                         interpret=True)
POLICIES = {"library": (LIBRARY, XLA), "kernel": (KERNEL, JAX_KERNEL)}
#: the attention patterns of the window repair: every layer windowed, and
#: local (window) / global layers alternating
PATTERNS = {"swa": (AttentionPattern("swa", window=8),
                    JAttentionPattern("swa", window=8)),
            "local_global": (
                AttentionPattern("local_global", window=8, local_ratio=1),
                JAttentionPattern("local_global", window=8, local_ratio=1))}


@pytest.fixture(scope="module")
def smoke():
    """(cfg, JAX cfg, JAX model, JAX params, port params) per arch,
    compute dtype and attention pattern."""
    cache = {}

    def get(arch, dtype, pattern=None):
        key = (arch, dtype, pattern)
        if key not in cache:
            cfg = dataclasses.replace(configs.get_smoke(arch), dtype=dtype)
            jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype)
            if pattern is not None:
                cfg = dataclasses.replace(cfg, attn=PATTERNS[pattern][0])
                jcfg = dataclasses.replace(jcfg, attn=PATTERNS[pattern][1])
            jmodel = jregistry.build(jcfg)
            jparams = jmodel.init(jax.random.PRNGKey(0))
            tparams = lm.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           cfg, device="cpu")
            cache[key] = (cfg, jcfg, jmodel, jparams, tparams)
        return cache[key]
    return get


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# -- the wave path's parts ----------------------------------------------------

@pytest.mark.parametrize("W,pos,window", [(16, 10, None), (16, 15, 5),
                                          (8, 20, None), (8, 21, 6)])
def test_decode_attend_matches_jax(W, pos, window):
    """Linear (W > pos) and ring (W <= pos) buffers, with and without a
    window, GQA 4 over 2."""
    rng = np.random.RandomState(W + pos)
    q = rng.randn(2, 4, 1, 16).astype(np.float32)
    kb = rng.randn(2, 2, W, 16).astype(np.float32)
    vb = rng.randn(2, 2, W, 16).astype(np.float32)
    want = JL.decode_attend(jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
                            jnp.asarray(pos, jnp.int32), window=window,
                            scale=0.25)
    got = L.decode_attend(*(torch.from_numpy(a) for a in (q, kb, vb)), pos,
                          window=window, scale=0.25)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,W", [(12, 8), (12, 12), (5, 8), (13, 5)])
def test_ring_pad_matches_jax(S, W):
    k = np.random.RandomState(S * W).randn(2, 3, S, 4).astype(np.float32)
    want = jlm._ring_pad(jnp.asarray(k), W, jnp.bfloat16)
    got = lm._ring_pad(torch.from_numpy(k), W, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


@pytest.mark.parametrize("pattern", [None, "swa", "local_global"])
def test_init_cache_matches_jax(smoke, pattern):
    cfg, jcfg, _jm, _jp, _tp = smoke(OLMO, "bfloat16", pattern)
    for seq_len in (5, 40):
        want = jlm.init_cache(jcfg, 3, seq_len, jnp.bfloat16, prefill_len=4)
        got = registry.build(cfg).init_cache(3, seq_len, torch.bfloat16, 4,
                                             "cpu")
        assert lm.cache_buffer_len(cfg, seq_len) == \
            jlm.cache_buffer_len(jcfg, seq_len)
        assert got.pos == int(want.pos) == 4
        for t, j in ((got.attn_k, want.attn_k), (got.attn_v, want.attn_v)):
            assert tuple(t.shape) == j.shape and t.dtype == torch.bfloat16
            assert not t.any()


# -- logits: prefill + decode -------------------------------------------------

class _PinnedExperts:
    """The JAX router's top-k choices, recorded as JAX runs (an ordered
    debug callback on ``lax.top_k``) and handed, in call order, to the
    port's router (``layers._top_k``), which keeps its own probabilities
    and records where its own choice differed.  In bf16 a near-tie
    between two experts' probabilities can resolve differently in the
    two frameworks, whose bf16 roundings differ; pinning the choices
    holds the rest of the arithmetic to the tolerance."""

    def __init__(self, monkeypatch):
        self.jax_choices, self.flips = [], []
        top_k = jax.lax.top_k
        port_top_k = L._top_k

        def jax_top_k(probs, k):
            vals, idx = top_k(probs, k)
            jax.debug.callback(
                lambda i: self.jax_choices.append(np.array(i)), idx,
                ordered=True)
            return vals, idx

        def pinned_top_k(probs, k):
            jax.effects_barrier()
            idx = torch.from_numpy(self.jax_choices.pop(0)).long()
            own = port_top_k(probs, k)[1]
            flipped = (own.sort(-1).values != idx.sort(-1).values).any(-1)
            ranked = probs.sort(-1, descending=True).values
            self.flips += (ranked[flipped, k - 1]
                           - ranked[flipped, k]).tolist()
            return probs.gather(-1, idx), idx

        monkeypatch.setattr(jax.lax, "top_k", jax_top_k)
        monkeypatch.setattr(L, "_top_k", pinned_top_k)


def _wave_both(smoke, arch, dtype, policy, pattern=None, steps=3):
    """A left-padded wave of two prompts (13 and 6 tokens) through
    prefill, then ``steps`` decode steps, on both packages; returns
    [(port, JAX)] for each step's logits and the final K and V caches."""
    cfg, jcfg, _jm, jparams, tparams = smoke(arch, dtype, pattern)
    be, jbe = POLICIES[policy]
    rng = np.random.RandomState(3)
    toks = rng.randint(0, cfg.vocab, (2, 13))
    toks[1, :7] = 0
    cache_len = 13 + steps
    jl, jc = jlm.prefill(jparams, jcfg, jbe, jnp.asarray(toks, jnp.int32),
                         cache_len=cache_len)
    jax.block_until_ready(jl)
    tl, tc = lm.prefill(tparams, cfg, be, torch.from_numpy(toks),
                        cache_len=cache_len)
    out = [(tl, _np(jl))]
    for _ in range(steps):
        nxt = rng.randint(0, cfg.vocab, (2, 1))
        jl, jc = jlm.decode(jparams, jcfg, jbe, jnp.asarray(nxt, jnp.int32),
                            jc)
        jax.block_until_ready(jl)
        tl, tc = lm.decode(tparams, cfg, be, torch.from_numpy(nxt), tc)
        assert tc.pos == int(jc.pos)
        out.append((tl, _np(jl)))
    # the cache left behind: ring order, padding and contents
    out += [(tc.attn_k, _np(jc.attn_k)), (tc.attn_v, _np(jc.attn_v))]
    return out


def _check(pairs, dtype):
    for got, want in pairs:
        got = got.float().numpy()
        assert got.shape == want.shape
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        else:
            err = np.abs(got - want)
            assert err.max() < 0.1, err.max()
            assert err.mean() < 0.01, err.mean()


@pytest.mark.parametrize("arch", [OLMO, MOE])
@pytest.mark.parametrize("policy", ["library", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wave_logits_match_jax(smoke, monkeypatch, arch, policy, dtype):
    """The MoE model in bf16 runs with its expert choices pinned to
    JAX's (see :class:`_PinnedExperts`); every choice that differed must
    be a near-tie, the k-th and (k+1)-th probabilities within 1e-2 (the
    router's bf16 inputs differ by a few bf16 steps)."""
    pin = arch == MOE and dtype == "bfloat16"
    pinned = _PinnedExperts(monkeypatch) if pin else None
    _check(_wave_both(smoke, arch, dtype, policy), dtype)
    if pin:
        assert not pinned.jax_choices          # every choice consumed
        assert all(0 <= gap < 1e-2 for gap in pinned.flips), pinned.flips


# -- tokens -------------------------------------------------------------------

def _prompts(seed, lens, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n) for n in lens]


def _serve(engine, prompts, maxnew, dtype=np.int64):
    for rid, (p, mn) in enumerate(zip(prompts, maxnew)):
        req = (JRequest if isinstance(engine, JBatcher) else Request)
        engine.submit(req(rid, p.astype(dtype), max_new=mn))
    return engine.run()


@pytest.mark.parametrize("policy", ["library", "kernel"])
def test_batcher_tokens_match_jax_batcher(smoke, policy):
    """Temperature 0, f32, 5 requests on 2 slots: three left-padded waves
    of mixed lengths; the same tokens as the JAX ContinuousBatcher."""
    cfg, _jcfg, jmodel, jparams, tparams = smoke(OLMO, "float32")
    be, jbe = POLICIES[policy]
    prompts = _prompts(4, (5, 9, 3, 17, 11))
    maxnew = [6, 5, 7, 3, 4]
    want = _serve(JBatcher(jmodel, jparams, jbe, slots=2, max_len=64,
                           eos=-1), prompts, maxnew, np.int32)
    got = _serve(ContinuousBatcher(registry.build(cfg), tparams, be, slots=2,
                                   max_len=64, eos=-1, device="cpu"),
                 prompts, maxnew)
    assert got == want


@pytest.mark.parametrize("policy,dtype", [("library", "bfloat16"),
                                          ("library", "float32"),
                                          ("kernel", "float32")])
def test_batcher_one_slot_matches_paged_engine(smoke, policy, dtype):
    """``slots=1`` is exact unbatched generation, the oracle the paged
    engine is held to (as ``tests/test_serve_fuzz.py`` holds the
    reference's).  In bf16 the flash kernel keeps its probabilities in
    f32 where the paged prefill rounds them, so bf16 is held on the
    library path, whose order the paged prefill mirrors."""
    cfg, *_rest, tparams = smoke(OLMO, dtype)
    be = POLICIES[policy][0]
    model = registry.build(cfg)
    prompts = _prompts(5, (5, 9, 3, 17, 26))
    maxnew = [6, 5, 9, 3, 7]
    want = _serve(PagedEngine(model, tparams, be, slots=2, max_len=64,
                              block_size=8, chunk=8, eos=-1, device="cpu"),
                  prompts, maxnew)
    got = _serve(ContinuousBatcher(model, tparams, be, slots=1, max_len=64,
                                   eos=-1, device="cpu"), prompts, maxnew)
    assert got == want


# -- windows: the paged and the wave path take each layer's window ------------

def _paged_both(smoke, pattern):
    """One 13-token prefill chunk then 4 decode steps through the paged
    path of both packages (the JAX side forced XLA, the port forced
    kernel), for an olmo-smoke with ``pattern``."""
    cfg, jcfg, _jm, jparams, tparams = smoke(OLMO, "float32", pattern)
    BS, nblocks, C = 8, 5, 16
    jps = jlm.init_paged_state(jcfg, nblocks, BS, 1, jcfg.compute_dtype)
    tps = lm.init_paged_state(cfg, nblocks, BS, 1, cfg.compute_dtype,
                              device="cpu")
    table = np.array([[1, 2, 3, 4]], np.int32)
    rng = np.random.RandomState(6)
    toks = np.zeros((1, C), np.int32)
    toks[0, :13] = rng.randint(0, cfg.vocab, 13)
    jl, jps = jlm.paged_prefill(jparams, jcfg, XLA, jnp.asarray(toks), jps,
                                jnp.asarray(table), jnp.asarray([0], jnp.int32),
                                0, 13, 13)
    tl = lm.paged_prefill(tparams, cfg, KERNEL, torch.from_numpy(toks).long(),
                          tps, torch.from_numpy(table).long(),
                          torch.tensor([0]), 0, 13, 13)
    out = [(tl[0, :13], _np(jl)[0, :13])]
    for pos in range(13, 17):
        nxt = rng.randint(0, cfg.vocab, (1, 1)).astype(np.int32)
        jl, jps = jlm.paged_decode(jparams, jcfg, XLA, jnp.asarray(nxt), jps,
                                   jnp.asarray(table),
                                   jnp.asarray([pos], jnp.int32),
                                   jnp.ones((1,), bool))
        tl = lm.paged_decode(tparams, cfg, KERNEL, torch.from_numpy(nxt).long(),
                             tps, torch.from_numpy(table).long(),
                             torch.tensor([pos]))
        out.append((tl, _np(jl)))
    return out


@pytest.mark.parametrize("pattern", ["swa", "local_global"])
def test_windowed_paged_logits_match_jax(smoke, pattern):
    _check(_paged_both(smoke, pattern), "float32")


@pytest.mark.parametrize("pattern", ["swa", "local_global"])
@pytest.mark.parametrize("policy", ["library", "kernel"])
def test_windowed_wave_logits_match_jax(smoke, pattern, policy):
    """13-token prompts against a window of 8, then 4 decode steps (a
    ring buffer of 8 slots under ``swa``)."""
    _check(_wave_both(smoke, OLMO, "float32", policy, pattern, steps=4),
           "float32")


def test_window_changes_the_logits(smoke):
    """The windowed configs are not served as full attention (the
    paged path once ignored the window)."""
    full = _paged_both(smoke, None)
    for pattern in PATTERNS:
        got = _paged_both(smoke, pattern)
        assert not np.allclose(got[-1][1], full[-1][1], atol=1e-3)
        assert not np.allclose(got[-1][0].numpy(), full[-1][0].numpy(),
                               atol=1e-3)
