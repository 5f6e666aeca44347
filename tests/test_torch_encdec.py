"""The port's enc-dec family (seamless-smoke) against the JAX package's.

JAX initialises seamless-smoke (2 encoder + 2 decoder layers, d_model 64,
4 heads of 16, vocab 512) in f32; ``encdec.params_from_numpy`` carries
its weights into the port, and the same numpy inputs (tokens, and frame
embeddings standing in for the audio frontend) go through both.  Two
pairs of policies: the port's ``library`` (the chunked attention oracle)
against the reference's ``xla`` (``chunked_mha``), and the port's
``kernel`` (on the CPU every wrapper's plain version:
``flash_attention_plain`` for flash) against the reference's ``pallas``
(its Pallas flash kernel in interpret mode).

Tolerances are those of ``tests/test_torch_families.py``: everything is
f32, where the two packages differ only in summation order, so logits
and caches of size O(1) are held within 1e-4 (rtol and atol) and greedy
tokens are identical; the reference's own prefill/decode consistency
test holds the port at its 1e-4 of the largest logit.  The decoder
prompts are longer than one token and decode runs several steps, so a
rope applied to the cross attention's q or k would show.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import encdec as jencdec, registry as jregistry
from repro.models.common import PALLAS_INTERPRET, XLA
from repro_torch import api, configs
from repro_torch.kernels import flash_attention
from repro_torch.launch import serve as serve_mod
from repro_torch.models import encdec, frontends, registry

ARCH = "seamless-m4t-large-v2"
#: port policy -> the reference's counterpart
POLICIES = {"library": XLA, "kernel": PALLAS_INTERPRET}
TOL = 1e-4
S_SRC, S_TGT, STEPS = 37, 5, 3

_MODELS = {}


def _models():
    """(port cfg, JAX cfg, JAX model, JAX params, port params), f32."""
    if not _MODELS:
        jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="float32")
        jmodel = jregistry.build(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        cfg = dataclasses.replace(configs.get_smoke(ARCH), dtype="float32")
        tparams = encdec.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           cfg, device="cpu")
        _MODELS.update(cfg=cfg, jcfg=jcfg, jmodel=jmodel, jparams=jparams,
                       tparams=tparams)
    m = _MODELS
    return m["cfg"], m["jcfg"], m["jmodel"], m["jparams"], m["tparams"]


def _inputs(B=2, S_tgt=S_TGT, S_src=S_SRC, seed=1):
    """Tokens (B, S_tgt) and frames (B, S_src, d) as numpy."""
    cfg = _models()[0]
    rng = np.random.RandomState(seed)
    return (rng.randint(0, cfg.vocab, (B, S_tgt)),
            (0.02 * rng.randn(B, S_src, cfg.d_model)).astype(np.float32))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL):
    got = got.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _policy(name):
    return api.Policy(backend=name)


# -- config and registry -------------------------------------------------------

@pytest.mark.parametrize("get", ["get_config", "get_smoke"])
def test_config_matches_reference(get):
    cfg, jcfg = getattr(configs, get)(ARCH), getattr(jconfigs, get)(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.vocab_padded, cfg.param_count()) == (jcfg.vocab_padded,
                                                     jcfg.param_count())
    if get == "get_config":
        assert (cfg.family, cfg.n_encoder_layers, cfg.n_layers, cfg.d_model,
                cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff,
                cfg.vocab_padded, cfg.tie_embeddings) == (
            "audio", 24, 24, 1024, 16, 16, 64, 8192, 256256, False)


def test_registry_builds_enc_dec_without_paged_entries():
    cfg = _models()[0]
    model = registry.build(cfg)
    assert (model.paged_prefill, model.paged_decode,
            model.init_paged_state) == (None, None, None)
    assert registry.build(dataclasses.replace(cfg, family="encdec")) \
        .paged_decode is None
    cache = model.init_cache(2, 9, torch.float32, src_len=S_SRC,
                             device="cpu")
    assert cache.pos == 9
    assert tuple(cache.self_k.shape) == (cfg.n_layers, 2, 4, 9, 16)
    assert tuple(cache.cross_v.shape) == (cfg.n_layers, 2, 4, S_SRC, 16)


def test_init_encdec_shapes_match_params_from_numpy():
    cfg, _jcfg, _jm, _jp, tparams = _models()
    mine = encdec.init_encdec(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    want = {k: tuple(v.shape) for k, v in tparams.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in mine.state_dict().items()} == want
    assert len(mine.enc_blocks) == cfg.n_encoder_layers
    assert len(mine.dec_blocks) == cfg.n_layers


def test_launcher_refuses_seamless(monkeypatch):
    """The reference's launcher refuses the family (no serving engine
    passes ``src_embeds``), and so does the port's, before any device
    check."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--smoke",
                                      "--device", "cpu"])
    with pytest.raises(SystemExit, match="decoder-only"):
        serve_mod.main()


def test_fake_frontend_has_the_audio_shape():
    cfg = configs.get_config(ARCH)
    assert frontends.frontend_embed_shape(cfg, 4, 1000) == (4, 1000, 1024)
    x = frontends.fake_frontend(torch.Generator().manual_seed(0),
                                _models()[0], 2, S_SRC, device="cpu")
    assert tuple(x.shape) == (2, S_SRC, 64) and x.dtype == torch.bfloat16


# -- against the JAX package ---------------------------------------------------

@pytest.mark.parametrize("policy", list(POLICIES))
def test_encode_matches_jax(policy):
    cfg, jcfg, _jm, jparams, tparams = _models()
    _toks, src = _inputs()
    want = jencdec.encode(jparams, jcfg, POLICIES[policy], jnp.asarray(src))
    got = encdec.encode(tparams, cfg, _policy(policy), torch.from_numpy(src))
    _close(got, _np(want))


@pytest.mark.parametrize("policy", list(POLICIES))
def test_forward_train_matches_jax(policy):
    cfg, _jcfg, jmodel, jparams, tparams = _models()
    toks, src = _inputs()
    want, jaux = jmodel.forward_train(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32),
                  "src_embeds": jnp.asarray(src)}, POLICIES[policy])
    got, aux = registry.build(cfg).forward_train(
        tparams, torch.from_numpy(toks), _policy(policy),
        torch.from_numpy(src))
    assert tuple(got.shape) == (2, S_TGT, cfg.vocab_padded)
    assert float(aux) == float(jaux) == 0.0
    _close(got, _np(want))


@pytest.mark.parametrize("policy", list(POLICIES))
def test_prefill_caches_and_decode_match_jax(policy):
    """Prefill of 5 prompt tokens over 37 frames, into a cache of 8
    positions: the logits and all four caches; then three decode steps'
    logits and the self caches they leave."""
    cfg, _jcfg, jmodel, jparams, tparams = _models()
    toks, src = _inputs()
    jbe, be = POLICIES[policy], _policy(policy)
    model = registry.build(cfg)
    W = S_TGT + STEPS
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32),
                                      "src_embeds": jnp.asarray(src)}, jbe,
                            cache_len=W)
    tl, tc = model.prefill(tparams, torch.from_numpy(toks), be, cache_len=W,
                           src_embeds=torch.from_numpy(src))
    assert tc.pos == int(jc.pos) == S_TGT
    _close(tl, _np(jl))
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        _close(getattr(tc, name), _np(getattr(jc, name)))
    rng = np.random.RandomState(2)
    for _ in range(STEPS):
        nxt = rng.randint(0, cfg.vocab, (2, 1))
        jl, jc = jmodel.decode(jparams, {"tokens": jnp.asarray(nxt,
                                                               jnp.int32)},
                               jc, jbe)
        tl, tc = model.decode(tparams, torch.from_numpy(nxt), tc, be)
        assert tc.pos == int(jc.pos)
        _close(tl, _np(jl))
    _close(tc.self_k, _np(jc.self_k))
    _close(tc.self_v, _np(jc.self_v))


@pytest.mark.parametrize("policy", list(POLICIES))
def test_forward_train_consistent_with_prefill_and_decode(policy):
    """The reference's ``test_prefill_decode_consistency`` on the port:
    forward_train over S + 1 tokens against prefill of S and one decode
    step, at its 1e-4 of the largest logit."""
    cfg, *_rest, tparams = _models()
    toks, src = _inputs(S_tgt=18, S_src=17, seed=3)
    toks, src, be = torch.from_numpy(toks), torch.from_numpy(src), \
        _policy(policy)
    model = registry.build(cfg)
    full, _ = model.forward_train(tparams, toks, be, src)
    lp, cache = model.prefill(tparams, toks[:, :17], be, cache_len=18,
                              src_embeds=src)
    ld, _ = model.decode(tparams, toks[:, 17:], cache, be)
    scale = full.abs().max().item() + 1e-6
    assert (lp - full[:, -2]).abs().max().item() / scale < 1e-4
    assert (ld - full[:, -1]).abs().max().item() / scale < 1e-4


def _jax_greedy(jmodel, jparams, toks, src, steps):
    logits, cache = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32),
                  "src_embeds": jnp.asarray(src)}, XLA,
        cache_len=toks.shape[1] + steps)
    out = []
    for _ in range(steps):
        nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(np.asarray(nxt)[:, 0])
        logits, cache = jmodel.decode(jparams, {"tokens": nxt}, cache, XLA)
    return np.stack(out, 1)


@pytest.mark.parametrize("policy", ["library", "kernel"])
def test_greedy_tokens_match_jax(policy):
    """2 requests x 8 greedy steps through ``registry.Model``, token for
    token against a JAX greedy loop over the reference's ``Model``."""
    cfg, _jcfg, jmodel, jparams, tparams = _models()
    toks, src = _inputs(seed=4)
    steps = 8
    want = _jax_greedy(jmodel, jparams, toks, src, steps)
    model, be = registry.build(cfg), _policy(policy)
    logits, cache = model.prefill(tparams, torch.from_numpy(toks), be,
                                  cache_len=S_TGT + steps,
                                  src_embeds=torch.from_numpy(src))
    got = []
    for _ in range(steps):
        nxt = logits.argmax(-1, keepdim=True)
        got.append(nxt[:, 0].numpy())
        logits, cache = model.decode(tparams, nxt, cache, be)
    np.testing.assert_array_equal(np.stack(got, 1), want)


@pytest.mark.parametrize("backend,per_encode,per_prefill,per_decode", [
    ("kernel", 2, 6, 2), ("auto", 2, 6, 2), ("library", 0, 0, 0)])
def test_flash_calls_per_entry(monkeypatch, backend, per_encode,
                               per_prefill, per_decode):
    """Under every policy but the forced library the flash wrapper runs
    once a layer in the encoder (prefill runs it too), twice a decoder
    layer at prefill (self, cross) and once a decoder layer at each
    decode step: the cross
    attention at Sq = 1, non-causal, against every frame; the library
    calls it never."""
    cfg, *_rest, tparams = _models()
    calls = []
    orig = flash_attention.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw["causal"]))
        return orig(q, k, v, **kw)
    monkeypatch.setattr(flash_attention, "flash_attention", spy)
    toks, src = (torch.from_numpy(a) for a in _inputs())
    be = _policy(backend)
    encdec.encode(tparams, cfg, be, src)
    assert len(calls) == per_encode
    assert all(c == (S_SRC, S_SRC, False) for c in calls)
    del calls[:]
    _l, cache = encdec.prefill(tparams, cfg, be, toks, src, cache_len=8)
    assert len(calls) == per_prefill
    del calls[:]
    encdec.decode(tparams, cfg, be, toks[:, :1], cache)
    assert calls == [(1, S_SRC, False)] * per_decode
