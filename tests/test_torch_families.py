"""The dense and MoE configs of the port's tenth slice (gemma3-1b,
smollm-360m, glm4-9b, mixtral-8x22b) and head padding, against the JAX
package on the same weights.

JAX initialises each smoke config; ``params_from_numpy`` carries its
weights, attention heads in their padded shapes, into the port.  The JAX
side runs forced XLA (``chunked_mha`` over a whole prompt), the port the
forced kernel, whose wrappers on the CPU are their plain versions (flash
attention at smollm-smoke's head dim 20 zero-padded to 32).  Everything
is f32, where the two packages differ only in summation order: logits of
size O(1) within 1e-4, engine tokens identical.

The helpers here are shared with ``test_torch_hybrid.py``.
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm, registry as jregistry
from repro.models.common import XLA
from repro.serve import PagedEngine as JPagedEngine, Request as JRequest
from repro_torch import api, configs
from repro_torch.launch import serve as serve_mod
from repro_torch.models import encdec, lm, registry
from repro_torch.serve import PagedEngine, Request

KERNEL = api.Policy(backend="kernel")
#: the slice's dense and MoE configs
DENSE = ["gemma3-1b", "smollm-360m", "glm4-9b", "mixtral-8x22b"]
#: the slice's hybrid and VLM configs (``test_torch_hybrid.py``)
HYBRID = ["zamba2-7b", "internvl2-2b"]
#: the cache and pool tensors the two packages both keep
STATE = ("attn_k", "attn_v", "conv", "ssm", "shared_k", "shared_v")


@functools.lru_cache(maxsize=None)
def jax_and_port(arch):
    """(port cfg, JAX cfg, JAX model, JAX params, port params) of
    ``arch``'s smoke config in f32."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype="float32")
    jmodel = jregistry.build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    tparams = lm.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    return cfg, jcfg, jmodel, jparams, tparams


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def state_pairs(port, ref):
    """(port, JAX) for each cache or pool tensor the port keeps."""
    out = []
    for name in STATE:
        t = getattr(port, name)
        assert (t is None) == (getattr(ref, name) is None), name
        if t is not None:
            out.append((t, _np(getattr(ref, name))))
    return out


def check(pairs, tol=1e-4):
    for got, want in pairs:
        got = got.float().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def wave_both(arch, lens=(21, 9), steps=3, prefix=None, params=None):
    """A left-padded wave of prompts of ``lens`` tokens (after the
    ``prefix`` embeddings, numpy (B, P, d), when given) through prefill,
    then ``steps`` decode steps, on both packages; returns [(port, JAX)]
    for each step's logits and the cache left behind.  ``params``
    replaces the port's weights."""
    cfg, jcfg, _jm, jparams, tparams = jax_and_port(arch)
    tparams = params if params is not None else tparams
    rng = np.random.RandomState(3)
    S = max(lens)
    toks = rng.randint(0, cfg.vocab, (len(lens), S))
    for i, n in enumerate(lens):
        toks[i, :S - n] = 0
    P = 0 if prefix is None else prefix.shape[1]
    cache_len = P + S + steps
    jl, jc = jlm.prefill(jparams, jcfg, XLA, jnp.asarray(toks, jnp.int32),
                         None if prefix is None else jnp.asarray(prefix),
                         cache_len=cache_len)
    tl, tc = lm.prefill(tparams, cfg, KERNEL, torch.from_numpy(toks),
                        cache_len=cache_len,
                        prefix_embeds=None if prefix is None
                        else torch.from_numpy(prefix))
    out = [(tl, _np(jl))]
    for _ in range(steps):
        nxt = rng.randint(0, cfg.vocab, (len(lens), 1))
        jl, jc = jlm.decode(jparams, jcfg, XLA, jnp.asarray(nxt, jnp.int32),
                            jc)
        tl, tc = lm.decode(tparams, cfg, KERNEL, torch.from_numpy(nxt), tc)
        assert tc.pos == int(jc.pos)
        out.append((tl, _np(jl)))
    return out + state_pairs(tc, jc)


def paged_both(arch, steps=3):
    """Two slots through the paged path of both packages: a 20-token
    chunk whose rows past 14 replay decoded tokens (recompute-resume,
    ``n_prompt`` 14), a fresh 7-token prompt, then ``steps`` decode steps
    over both slots; returns [(port, JAX)] for the logits and the pools
    and carries left behind."""
    cfg, jcfg, _jm, jparams, tparams = jax_and_port(arch)
    rng = np.random.RandomState(0)
    BS, nblocks, slots, C = 8, 9, 2, 24
    jps = jlm.init_paged_state(jcfg, nblocks, BS, slots, jcfg.compute_dtype)
    tps = lm.init_paged_state(cfg, nblocks, BS, slots, cfg.compute_dtype,
                              device="cpu")
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    out = []
    for slot, (n, n_prompt) in enumerate(((20, 14), (7, 7))):
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = rng.randint(0, cfg.vocab, n)
        jl, jps = jlm.paged_prefill(
            jparams, jcfg, XLA, jnp.asarray(toks), jps,
            jnp.asarray(tables[slot:slot + 1]), jnp.asarray([0], jnp.int32),
            slot, n, n_prompt)
        tl = lm.paged_prefill(
            tparams, cfg, KERNEL, torch.from_numpy(toks).long(), tps,
            torch.from_numpy(tables[slot:slot + 1]).long(),
            torch.tensor([0]), slot, n, n_prompt)
        out.append((tl[0, :n], _np(jl)[0, :n]))
    pos = np.array([20, 7], np.int32)
    for _ in range(steps):
        toks = rng.randint(0, cfg.vocab, (slots, 1)).astype(np.int32)
        jl, jps = jlm.paged_decode(
            jparams, jcfg, XLA, jnp.asarray(toks), jps, jnp.asarray(tables),
            jnp.asarray(pos), jnp.ones((slots,), bool))
        tl = lm.paged_decode(tparams, cfg, KERNEL,
                             torch.from_numpy(toks).long(), tps,
                             torch.from_numpy(tables).long(),
                             torch.from_numpy(pos).long())
        out.append((tl, _np(jl)))
        pos = pos + 1
    return out + state_pairs(tps, jps)


def engine_both(arch):
    """Temperature 0, 4 requests of mixed lengths on 2 slots (chunked
    prefill, mid-flight admission, slot reuse): (port tokens, JAX tokens,
    port engine)."""
    cfg, _jcfg, jmodel, jparams, tparams = jax_and_port(arch)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab, n) for n in (5, 9, 3, 17)]
    kw = dict(slots=2, max_len=64, block_size=8, chunk=8, eos=-1)
    je = JPagedEngine(jmodel, jparams, XLA, **kw)
    te = PagedEngine(registry.build(cfg), tparams, KERNEL, device="cpu",
                     **kw)
    for rid, (p, mn) in enumerate(zip(prompts, (6, 5, 6, 3))):
        je.submit(JRequest(rid, p.astype(np.int32), max_new=mn))
        te.submit(Request(rid, p.astype(np.int64), max_new=mn))
    return te.run(), je.run(), te


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE + HYBRID)
def test_config_matches_reference(arch):
    """The reference's numbers and smoke() reduction, as they are.  The
    port's ``MoEConfig.dropless`` has no counterpart there: it is off in
    every such config, and the rest is the reference's."""
    for get in ("get_config", "get_smoke"):
        cfg, jcfg = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
        got = dataclasses.asdict(cfg)
        if got["moe"] is not None:
            assert got["moe"].pop("dropless") is False
        assert got == dataclasses.asdict(jcfg)
        assert (cfg.n_heads_padded, cfg.n_kv_heads_padded,
                cfg.vocab_padded, cfg.param_count()) == \
            (jcfg.n_heads_padded, jcfg.n_kv_heads_padded,
             jcfg.vocab_padded, jcfg.param_count())


def test_every_decoder_only_config_is_registered():
    """Every decoder-only config of the reference, and since the enc-dec
    slice the enc-dec one too: the reference's list as it is."""
    decoder_only = [a for a in jconfigs.ARCH_IDS
                    if jconfigs.get_config(a).family not in ("encdec",
                                                             "audio")]
    assert set(decoder_only) < set(configs.ARCH_IDS)
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS


# -- head padding --------------------------------------------------------------

@pytest.mark.parametrize("arch,heads,kv", [("gemma3-1b", 16, 4),
                                           ("smollm-360m", 48, 16)])
def test_padding_keeps_the_gqa_pairing(arch, heads, kv):
    """gemma3-1b 4/1 -> 16/4, smollm-360m 15/5 -> 48/16: a dead q head
    reads a dead KV head, a live one the live KV head it had."""
    cfg = configs.get_config(arch)
    assert (cfg.n_heads_padded, cfg.n_kv_heads_padded) == (heads, kv)
    rep = cfg.n_heads // cfg.n_kv_heads
    assert cfg.n_heads_padded // cfg.n_kv_heads_padded == rep
    for h in range(cfg.n_heads_padded):
        assert (h // rep < cfg.n_kv_heads) == (h < cfg.n_heads)


@pytest.mark.parametrize("arch", ["gemma3-1b", "smollm-360m"])
def test_padded_shapes_accepted_and_dead_heads_zero(arch):
    """The JAX package's padded parameters load as they come, and
    ``init_lm`` builds the same shapes with zero dead heads (wq, wk, wv
    columns past the live heads, wo rows)."""
    cfg, _jcfg, _jm, jparams, tparams = jax_and_port(arch)
    hd = cfg.head_dim_
    live_q, live_kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    mine = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    for i in range(cfg.n_layers):
        src = jparams["blocks"]["attn"]
        for p in (tparams, mine):
            a = p.blocks[i].attn
            for k in ("wq", "wk", "wv", "wo"):
                assert tuple(getattr(a, k).shape) == src[k][i].shape
            assert a.wq.shape[1] == cfg.n_heads_padded * hd
            assert not a.wq[:, live_q:].any() and a.wq[:, :live_q].any()
            assert not a.wk[:, live_kv:].any() and not a.wv[:, live_kv:].any()
            assert not a.wo[live_q:].any() and a.wo[:live_q].any()


@pytest.mark.parametrize("arch", ["gemma3-1b", "smollm-360m"])
def test_dead_heads_contribute_exactly_zero(arch):
    """Perturbing a dead head's wo rows leaves every logit bitwise as it
    was (its output is exactly 0); zeroing a live head changes them."""
    cfg, _jcfg, _jm, jparams, base = jax_and_port(arch)
    hd, H = cfg.head_dim_, cfg.n_heads

    def logits_with(edit):
        params = lm.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
        for blk in params.blocks:
            edit(blk.attn.wo)
        return [t for t, _ in wave_both(arch, params=params)[:4]]

    ref = [t for t, _ in wave_both(arch, params=base)[:4]]
    g = torch.Generator().manual_seed(5)
    dead = logits_with(lambda wo: wo[H * hd:].copy_(
        torch.randn(wo[H * hd:].shape, generator=g)))
    live = logits_with(lambda wo: wo[:hd].zero_())
    assert all(torch.equal(a, b) for a, b in zip(ref, dead))
    assert not any(torch.allclose(a, b, atol=1e-3) for a, b in zip(ref,
                                                                    live))


# -- logits and tokens against the JAX package ---------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_wave_logits_match_jax(arch):
    """Prompts of 21 and 9 tokens: past gemma3-smoke's window of 16 (its
    local layers) and mixtral-smoke's ring of 24 positions."""
    check(wave_both(arch))


@pytest.mark.parametrize("arch", DENSE)
def test_paged_logits_match_jax(arch):
    check(paged_both(arch))


@pytest.mark.parametrize("arch", DENSE)
def test_engine_tokens_match_jax_engine(arch):
    got, want, te = engine_both(arch)
    assert got == want
    assert te.cache.blocks_in_use == 0


# -- the launcher --------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE + HYBRID)
def test_launcher_serves_each_new_arch_on_the_cpu(arch, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--smoke", "--device", "cpu", "--requests",
        "2", "--max-new", "3", "--backend", "kernel"])
    serve_mod.main()
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out


def test_launcher_refuses_enc_dec(monkeypatch):
    """The launcher refuses the enc-dec config with the reference's
    message (the reference's launcher refuses it too), while
    ``registry.build`` gives the enc-dec and audio families their model,
    one with no paged entries."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch",
                                      "seamless-m4t-large-v2", "--smoke"])
    with pytest.raises(SystemExit, match="decoder-only arch"):
        serve_mod.main()
    for family in ("encdec", "audio"):
        cfg = dataclasses.replace(
            configs.get_smoke("seamless-m4t-large-v2"), family=family)
        model = registry.build(cfg)
        assert model.paged_decode is None
        assert isinstance(model.init(torch.Generator().manual_seed(0),
                                     "cpu"), encdec.EncDec)


# -- forward_train: the attention families -------------------------------------

#: forward_train parity on top of :data:`DENSE`: moonshot-smoke (the MoE
#: layer's aux loss)
FORWARD = DENSE + ["moonshot-v1-16b-a3b"]


def forward_both(arch, S=21, prefix=None):
    """forward_train of 2 x S tokens (after ``prefix`` (B, P, d), numpy,
    when given) on both packages: the port under the forced kernel (flash
    on its plain version, every layer with its own window), the reference
    under XLA.  Returns ((port logits, aux), (JAX logits, aux))."""
    cfg, _jcfg, jmodel, jparams, tparams = jax_and_port(arch)
    toks = np.random.RandomState(5).randint(0, cfg.vocab, (2, S))
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    if prefix is not None:
        batch["prefix_embeds"] = jnp.asarray(prefix)
    want = jmodel.forward_train(jparams, batch, XLA)
    got = registry.build(cfg).forward_train(
        tparams, torch.from_numpy(toks), KERNEL,
        None if prefix is None else torch.from_numpy(prefix))
    return got, want


@pytest.mark.parametrize("arch", FORWARD)
def test_forward_train_matches_jax(arch):
    """21 tokens: past gemma3-smoke's window of 16 on its local layers
    (each layer's window, as the reference's ``lax.cond`` picks it).  The
    aux loss is the MoE layers' mean (moonshot, mixtral; the routers'
    probabilities and counts in f32), 0 for the dense configs."""
    (got, aux), (want, jaux) = forward_both(arch)
    cfg = jax_and_port(arch)[0]
    assert tuple(got.shape) == (2, 21, cfg.vocab_padded)
    check([(got, _np(want))])
    if cfg.family == "moe":
        assert float(jaux) > 0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    else:
        assert float(aux) == float(jaux) == 0.0
