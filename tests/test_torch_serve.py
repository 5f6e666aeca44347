"""The port's serving slice against the JAX package's, on the same weights.

JAX initialises olmo-smoke (2 layers, d_model 64, 4 heads, vocab 256);
``params_from_numpy`` carries those weights into the port, so both sides
run the same model.  The JAX side uses the forced-XLA policy its own
serving tests use; the port forces every routed GEMM onto its kernel
wrapper (on the CPU: the kernel's plain version).
"""
import ast
import dataclasses
import inspect
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs, obs as jobs
from repro.models import lm as jlm, registry as jregistry
from repro.models.common import XLA
from repro.serve import PagedEngine as JPagedEngine, Request as JRequest
from repro_torch import api, configs, obs
from repro_torch.launch import serve as serve_mod
from repro_torch.models import lm, registry
from repro_torch.serve import PagedEngine, Request

ROOT = pathlib.Path(__file__).resolve().parents[1]
KERNEL = api.Policy(backend="kernel")


@pytest.fixture(scope="module")
def smoke():
    """(cfg, JAX params as numpy, JAX model) per compute dtype."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            jcfg = dataclasses.replace(jconfigs.get_smoke("olmo-1b"),
                                       dtype=dtype)
            jmodel = jregistry.build(jcfg)
            jparams = jmodel.init(jax.random.PRNGKey(0))
            tree = jax.tree.map(np.asarray, jparams)
            cfg = dataclasses.replace(configs.get_smoke("olmo-1b"),
                                      dtype=dtype)
            cache[dtype] = (cfg, jcfg, jmodel, jparams, tree)
        return cache[dtype]
    return get


def test_params_from_numpy_carries_jax_weights(smoke):
    cfg, _jcfg, _jm, _jp, tree = smoke("bfloat16")
    p = lm.params_from_numpy(tree, cfg, device="cpu")
    assert len(p.blocks) == cfg.n_layers
    assert p.embed.dtype == torch.bfloat16
    assert p.final_norm is None and p.blocks[0].ln1 is None   # olmo
    assert p.unembed is None                                   # tied
    want = torch.tensor(tree["embed"]).to(torch.bfloat16)
    assert torch.equal(p.embed, want)
    for i, blk in enumerate(p.blocks):
        for mod, names in ((blk.attn, ("wq", "wk", "wv", "wo")),
                           (blk.mlp, ("wg", "wu", "wd"))):
            group = "attn" if mod is blk.attn else "mlp"
            for k in names:
                w = getattr(mod, k)
                src = tree["blocks"][group][k][i]
                assert tuple(w.shape) == src.shape   # (d_in, d_out) kept
                assert torch.equal(w, torch.tensor(src).to(w.dtype))


def _run_both(smoke, dtype):
    """A recompute-resume prefill chunk (rows past n_prompt), a fresh
    prefill in the other slot, then two decode steps over both slots —
    on both packages; returns [(port logits, JAX logits)]."""
    cfg, jcfg, _jm, jparams, tree = smoke(dtype)
    tparams = lm.params_from_numpy(tree, cfg, device="cpu")
    rng = np.random.RandomState(0)
    BS, nmax, nblocks, slots, C = 8, 4, 9, 2, 16
    jps = jlm.init_paged_state(jcfg, nblocks, BS, slots, jcfg.compute_dtype)
    tps = lm.init_paged_state(cfg, nblocks, BS, slots, cfg.compute_dtype,
                              device="cpu")
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    out = []
    for slot, (n, n_prompt) in enumerate(((11, 7), (5, 5))):
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = rng.randint(0, cfg.vocab, n)
        jl, jps = jlm.paged_prefill(
            jparams, jcfg, XLA, jnp.asarray(toks), jps,
            jnp.asarray(tables[slot:slot + 1]), jnp.asarray([0], jnp.int32),
            slot, n, n_prompt)
        tl = lm.paged_prefill(
            tparams, cfg, KERNEL, torch.from_numpy(toks).long(), tps,
            torch.from_numpy(tables[slot:slot + 1]).long(),
            torch.tensor([0]), n_prompt)
        out.append((tl[0, :n], np.asarray(jl, np.float32)[0, :n]))
    pos = np.array([11, 5], np.int32)
    for _ in range(2):
        toks = rng.randint(0, cfg.vocab, (slots, 1)).astype(np.int32)
        jl, jps = jlm.paged_decode(
            jparams, jcfg, XLA, jnp.asarray(toks), jps, jnp.asarray(tables),
            jnp.asarray(pos), jnp.ones((slots,), bool))
        tl = lm.paged_decode(tparams, cfg, KERNEL,
                             torch.from_numpy(toks).long(), tps,
                             torch.from_numpy(tables).long(),
                             torch.from_numpy(pos).long())
        out.append((tl, np.asarray(jl, np.float32)))
        pos = pos + 1
    return out


def test_paged_logits_match_jax_f32(smoke):
    """f32 compute: the two packages differ only in summation order, so
    the logits (O(1) in size) agree to 1e-4."""
    for got, want in _run_both(smoke, "float32"):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-4,
                                   atol=1e-4)


def test_paged_logits_match_jax_bf16(smoke):
    """bf16 compute: every projection, norm and residual rounds to bf16
    (8 bits of mantissa) and the two frameworks round at slightly
    different places; across 2 layers that stays within a few bf16 steps
    of logits of size O(1): atol 0.1, and the mean error far below it."""
    for got, want in _run_both(smoke, "bfloat16"):
        err = np.abs(got.float().numpy() - want)
        assert err.max() < 0.1, err.max()
        assert err.mean() < 0.01, err.mean()


def _serve_pair(smoke, dtype, prompts, maxnew, **kw):
    cfg, jcfg, jmodel, jparams, tree = smoke(dtype)
    je = JPagedEngine(jmodel, jparams, XLA, eos=-1, **kw)
    te = PagedEngine(registry.build(cfg),
                     lm.params_from_numpy(tree, cfg, device="cpu"), KERNEL,
                     eos=-1, device="cpu", **kw)
    for rid, (p, mn) in enumerate(zip(prompts, maxnew)):
        je.submit(JRequest(rid, p.astype(np.int32), max_new=mn))
        te.submit(Request(rid, p.astype(np.int64), max_new=mn))
    return te.run(), je.run(), te


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_tokens_match_jax_engine(smoke, dtype):
    """Temperature 0, 4 requests of mixed lengths on 2 slots (mid-flight
    admission, chunked prefill): the same tokens as the JAX PagedEngine."""
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 256, n) for n in (5, 9, 3, 17)]
    got, want, te = _serve_pair(smoke, dtype, prompts, [6, 5, 6, 3],
                                slots=2, max_len=64, block_size=8, chunk=8)
    assert got == want
    assert te.cache.blocks_in_use == 0


def test_engine_tokens_match_jax_engine_under_preemption(smoke):
    """A pool of 3 usable blocks for two requests that each need 2 forces
    preemption and recompute-resume; the continuation stays identical.
    Run in f32: with these prompts the bf16 runs meet a near-tie at token
    6 of request 0 (before any preemption) that the two frameworks'
    different bf16 rounding places resolves differently."""
    jobs.reset()
    obs.reset()
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 256, 7) for _ in range(2)]
    got, want, te = _serve_pair(smoke, "float32", prompts, [10, 10],
                                slots=2, max_len=24, block_size=8, chunk=8,
                                num_blocks=4)
    assert got == want
    assert obs.counter("serve.preemptions").value > 0
    assert te.cache.blocks_in_use == 0


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (f, n)


def test_entry_points_default_to_the_card(monkeypatch):
    """Every entry point defaults to CUDA; the CPU runs only when asked."""
    for fn, arg in ((serve_mod.serve, "device"),
                    (PagedEngine.__init__, "device"),
                    (lm.init_lm, "device"),
                    (lm.init_paged_state, "device"),
                    (lm.params_from_numpy, "device")):
        assert inspect.signature(fn).parameters[arg].default == "cuda", fn
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "olmo-1b",
                                      "--smoke"])
    if torch.cuda.is_available():
        assert PagedEngine.__init__  # the card is there: nothing to refuse
    else:
        with pytest.raises(SystemExit):
            serve_mod.main()
        cfg = configs.get_smoke("olmo-1b")
        # a CPU build of torch refuses CUDA with an AssertionError, a CUDA
        # build without a card with a RuntimeError
        with pytest.raises((RuntimeError, AssertionError)):
            lm.init_paged_state(cfg, 4, 8, 2)
    r = serve_mod.serve("olmo-1b", smoke=True, requests=2, max_new=3,
                        device="cpu", backend="kernel")
    assert r["tokens"] == 6
    assert all(p.device.type == "cpu" for p in r["params"].parameters())
