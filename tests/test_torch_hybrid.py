"""The hybrid (zamba2-7b) and VLM (internvl2-2b) families of the port
against the JAX package on the same weights.

zamba2 is the mamba backbone plus ONE shared [attn + mlp] block applied
before every ``shared_attn_every``-th layer, with a K/V cache per
application (the wave cache's and the paged state's ``shared_k``/``v``);
internvl2 is a dense decoder that takes its stub vision frontend's output
as ``prefix_embeds``.  As in ``test_torch_families.py`` (whose helpers
this file uses): the JAX side forced XLA, the port the forced kernel
(plain versions on the CPU), f32, logits within 1e-4, tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import frontends as jfrontends, lm as jlm
from repro.models.common import XLA
from repro_torch import api, configs
from repro_torch.kernels import flash_attention, ssd
from repro_torch.models import frontends, lm, registry

from test_torch_families import (HYBRID, KERNEL, check, engine_both,
                                 forward_both, jax_and_port, paged_both,
                                 wave_both)

ZAMBA, VLM = HYBRID


def _prefix(cfg, batch, seed=11):
    """A stand-in for the frontend's output, the same numbers for both."""
    shape = (batch, cfg.frontend_tokens or 8, cfg.d_model)
    return (np.random.RandomState(seed).randn(*shape) * 0.02).astype(
        np.float32)


# -- the shared block ----------------------------------------------------------

def test_shared_block_applications():
    """zamba2-7b: the shared block before layers 0, 6, ..., 78, ceil(81/6)
    = 14 applications; the smoke config before 0, 2, 4."""
    for cfg, apps in ((configs.get_config(ZAMBA), 14),
                      (configs.get_smoke(ZAMBA), 3)):
        at = [i for i in range(cfg.n_layers)
              if lm._shared_app(cfg, i) is not None]
        assert lm._n_shared_apps(cfg) == apps == len(at)
        assert at == list(range(0, cfg.n_layers, cfg.shared_attn_every))
        assert [lm._shared_app(cfg, i) for i in at] == list(range(apps))


def test_params_from_numpy_reads_the_shared_block():
    cfg, _jcfg, _jm, jparams, tparams = jax_and_port(ZAMBA)
    sh = jparams["shared"]
    for k in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(getattr(tparams.shared.attn, k).numpy(),
                                      np.asarray(sh["attn"][k]))
    for k in ("wg", "wu", "wd"):
        np.testing.assert_array_equal(getattr(tparams.shared.mlp, k).numpy(),
                                      np.asarray(sh["mlp"][k]))
    for k in ("ln1", "ln2"):
        np.testing.assert_array_equal(getattr(tparams.shared, k).numpy(),
                                      np.asarray(sh[k]))
    mine = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert mine.shared is not None and len(mine.blocks) == cfg.n_layers
    for a, b in zip(mine.shared.parameters(), tparams.shared.parameters()):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("arch", HYBRID)
def test_caches_and_pools_match_jax_shapes(arch):
    cfg, jcfg, *_ = jax_and_port(arch)
    for seq_len in (5, 40):
        want = jlm.init_cache(jcfg, 3, seq_len, jnp.float32, prefill_len=2)
        got = registry.build(cfg).init_cache(3, seq_len, torch.float32, 2,
                                             "cpu")
        assert lm.cache_buffer_len(cfg, seq_len) == \
            jlm.cache_buffer_len(jcfg, seq_len)
        for name in ("attn_k", "conv", "ssm", "shared_k", "shared_v"):
            t, j = getattr(got, name), getattr(want, name)
            assert (t is None) == (j is None), name
            assert t is None or tuple(t.shape) == j.shape
    want = jlm.init_paged_state(jcfg, 9, 8, 2, jnp.float32)
    got = lm.init_paged_state(cfg, 9, 8, 2, torch.float32, device="cpu")
    for name in ("attn_k", "conv", "ssm", "shared_k", "shared_v"):
        t, j = getattr(got, name), getattr(want, name)
        assert (t is None) == (j is None), name
        assert t is None or tuple(t.shape) == j.shape


# -- logits and tokens against the JAX package ---------------------------------

@pytest.mark.parametrize("arch", HYBRID)
def test_wave_logits_match_jax(arch):
    """Prefill and three decode steps; for zamba2 also the carries and
    each application's shared K/V left in the cache."""
    check(wave_both(arch))


@pytest.mark.parametrize("arch", HYBRID)
def test_paged_logits_match_jax(arch):
    """A recompute-resume chunk and a fresh prompt in two slots, three
    decode steps; for zamba2 also the shared pools and the carries."""
    check(paged_both(arch))


@pytest.mark.parametrize("arch", HYBRID)
def test_engine_tokens_match_jax_engine(arch):
    """The paged engine serves VLM text as the reference's does (no
    prefix)."""
    got, want, te = engine_both(arch)
    assert got == want
    assert te.cache.blocks_in_use == 0


@pytest.mark.parametrize("prefix", [False, True])
def test_zamba2_forward_train_matches_jax(prefix):
    """2 x 37 tokens (past two SSD chunks of 16), after 8 prefix
    embeddings when ``prefix``: the SSD scan in every mamba layer, flash
    in each shared-block application."""
    cfg, _jcfg, jmodel, jparams, tparams = jax_and_port(ZAMBA)
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (2, 37))
    pre = _prefix(cfg, 2) if prefix else None
    want, jaux = jmodel.forward_train(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32),
                  **({"prefix_embeds": jnp.asarray(pre)} if prefix else {})},
        XLA)
    got, aux = registry.build(cfg).forward_train(
        tparams, torch.from_numpy(toks), KERNEL,
        None if pre is None else torch.from_numpy(pre))
    assert tuple(got.shape) == (2, 37 + (8 if prefix else 0),
                                cfg.vocab_padded)
    assert float(aux) == float(jaux) == 0.0
    check([(got, np.asarray(want, np.float32))])


@pytest.mark.parametrize("backend,scans,flash", [("kernel", 5, 3),
                                                  ("auto", 5, 3),
                                                  ("library", 0, 0)])
def test_zamba2_forward_train_routes_ssd_and_flash(monkeypatch, backend,
                                                   scans, flash):
    """Under every policy but the forced library each of the 5 mamba
    layers calls the SSD wrapper once and each of the 3 applications of
    the shared block the flash wrapper once; the library calls neither
    (the chunked oracles instead)."""
    cfg, *_rest, tparams = jax_and_port(ZAMBA)
    calls = {"ssd": 0, "flash": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(ssd, "ssd_scan", counting("ssd", ssd.ssd_scan))
    monkeypatch.setattr(flash_attention, "flash_attention",
                        counting("flash", flash_attention.flash_attention))
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, cfg.vocab,
                                                             (1, 20)))
    lm.forward_train(tparams, cfg, api.Policy(backend=backend), toks)
    assert calls == {"ssd": scans, "flash": flash}


def test_internvl2_forward_train_matches_jax():
    """The VLM's forward_train: the frontend's embeddings as
    ``prefix_embeds`` before 2 x 21 tokens, against the reference's; the
    logits cover prefix and text."""
    cfg = jax_and_port(VLM)[0]
    pre = _prefix(cfg, 2)
    (got, aux), (want, jaux) = forward_both(VLM, prefix=pre)
    assert tuple(got.shape) == (2, pre.shape[1] + 21, cfg.vocab_padded)
    assert float(aux) == float(jaux) == 0.0
    check([(got, np.asarray(want, np.float32))])


# -- the VLM: its frontend's output as prefix_embeds ---------------------------

def test_internvl2_prefill_with_prefix_embeds_matches_jax():
    """8 frontend embeddings before prompts of 21 and 9 tokens, then three
    decode steps over the cache of prefix + text."""
    cfg = jax_and_port(VLM)[0]
    check(wave_both(VLM, prefix=_prefix(cfg, 2)))


def test_prefix_embeds_change_the_logits():
    cfg = jax_and_port(VLM)[0]
    with_prefix = wave_both(VLM, prefix=_prefix(cfg, 2))[0][0]
    without = wave_both(VLM)[0][0]
    assert not torch.allclose(with_prefix, without, atol=1e-3)


def test_frontend_helpers_match_the_reference():
    for arch in (VLM, ZAMBA):
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        for batch, seq in ((1, 1100), (3, 2048)):
            assert frontends.frontend_embed_shape(cfg, batch, seq) == \
                jfrontends.frontend_embed_shape(jcfg, batch, seq)
            assert frontends.text_len(cfg, seq) == \
                jfrontends.text_len(jcfg, seq)
    cfg = configs.get_smoke(VLM)
    g = torch.Generator().manual_seed(0)
    x = frontends.fake_frontend(g, cfg, 2, 16, device="cpu")
    assert tuple(x.shape) == (2, cfg.frontend_tokens, cfg.d_model)
    assert x.dtype == torch.bfloat16 and 0 < x.float().std() < 0.05
    with pytest.raises(ValueError, match="no frontend"):
        frontends.fake_frontend(g, configs.get_smoke(ZAMBA), 1, 4,
                                device="cpu")


def test_vlm_prefill_through_the_registry():
    """``registry.build(cfg).prefill`` passes ``prefix_embeds`` through,
    and the cache covers prefix and text."""
    cfg, *_rest, tparams = jax_and_port(VLM)
    pre = torch.from_numpy(_prefix(cfg, 1))
    toks = torch.zeros((1, 5), dtype=torch.long)
    model = registry.build(dataclasses.replace(cfg))
    logits, cache = model.prefill(tparams, toks, KERNEL, prefix_embeds=pre)
    want, _ = lm.prefill(tparams, cfg, KERNEL, toks, prefix_embeds=pre)
    assert torch.equal(logits, want)
    assert cache.pos == 5 + pre.shape[1] == cache.attn_k.shape[3]
