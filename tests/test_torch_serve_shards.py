"""Serving on several ranks: the wave path's prefill and decode on
DTensors (the reference's ``prefill`` / ``decode`` jitted with
``in_shardings``), held against one rank.

One gloo world of 4 ranks is spawned on the CPU (``launch/mesh.spawn``,
a ``FileStore``), once for the module: every family's case runs in it
and each test reads its case.  Each case draws the f32 smoke weights
from one seed, lays them out by the rules (``Rules.distribute``), the
tokens by ``data_specs`` and runs ``model.prefill`` and 3 decode steps
(teacher-forced from seeded tokens) under the activation context; the
cache comes out of prefill in the rules' cache layout
(``rules.cache_placements``).  Every step's logits, gathered whole, must
be within ``TOL`` of the one-rank run's max |logit|; the one-rank run is
held against the reference's decode in ``test_torch_serve.py`` and
``test_torch_families.py``.

* 2 x 2 for olmo, gemma3, mamba2, zamba2 (the hybrid's shared block),
  moonshot (the MoE prefill in 2 dispatch groups, the one-rank run in
  the same groups, ROADMAP §3 item 7), internvl2 (``prefix_embeds``) and
  seamless (the self and cross caches).
* The cache's sequence split: B 1 on 2 x 2 (the batch does not split,
  so the rules put the slots over ``data``) for olmo, for mixtral's
  32-slot ring past a 40-token prompt and for seamless (its prompt's 12
  self slots written 8 on one rank, 4 on the other; the cross slots
  split too); glm4 on 1 x 4, whose 2 kv heads
  do not split 4 ways (the slots go over ``model``).  Decode then takes
  the split softmax (``layers.split_decode_attend``).
* The split softmax alone, against ``layers.decode_attend`` on the whole
  buffer from the same numpy inputs: full and ring buffers, a window,
  slots split 2 and 4 ways.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api, configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import frontends, layers as L, registry
from repro_torch.parallel import rules as R, spmd
from repro_torch.parallel.ctx import activation_axes, activation_sharding

TOL = 1e-5            # of the one-rank logits' max |logit|, every step
TIMEOUT = 240.0
LIB = api.named_policy("library")
STEPS, SEED = 3, 5

#: (arch, mesh, batch, prompt length, cache length)
CASES = [(a, (2, 2), 4, 12, 16) for a in (
    "olmo-1b", "gemma3-1b", "mamba2-780m", "zamba2-7b",
    "moonshot-v1-16b-a3b", "internvl2-2b", "seamless-m4t-large-v2")] + [
    ("olmo-1b", (2, 2), 1, 12, 16), ("mixtral-8x22b", (2, 2), 1, 40, 48),
    ("seamless-m4t-large-v2", (2, 2), 1, 12, 16),
    ("glm4-9b", (1, 4), 4, 12, 16)]


def _cfg(arch):
    return dataclasses.replace(configs.get_smoke(arch), dtype="float32")


def _inputs(cfg, B, S):
    """The case's numpy inputs: prompt tokens, the decode steps' tokens
    and the frontend's embeddings, from one seed."""
    rng = np.random.default_rng(SEED)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)),
           "next": rng.integers(0, cfg.vocab, (STEPS, B, 1))}
    g = torch.Generator().manual_seed(SEED)
    if cfg.frontend == "vision":
        out["prefix_embeds"] = frontends.fake_frontend(
            g, cfg, B, cfg.frontend_tokens, torch.float32, "cpu").numpy()
    if cfg.frontend == "audio":
        out["src_embeds"] = frontends.fake_frontend(
            g, cfg, B, 8, torch.float32, "cpu").numpy()
    return out


def _whole(t):
    return (t.full_tensor() if spmd.is_dtensor(t) else t).float().numpy()


def _serve(arch, mesh_shape, B, S, W, groups=1):
    """Prefill and STEPS decode steps: every step's logits, whole.  On a
    mesh (``mesh_shape`` not None) a sharded run over this world, else
    one rank with the MoE layer in ``groups`` dispatch groups."""
    cfg = _cfg(arch)
    model = registry.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    inp = _inputs(cfg, B, S)

    def put(name, a, spec=None):
        t = torch.from_numpy(a)
        return t if spec is None else rules.distribute(t, spec)
    if mesh_shape is None:
        mesh = mesh_mod.mesh_shape((1, 1), ("data", "model"))
        act = {"_moe_shards": groups}
        specs = {}
    else:
        mesh = mesh_mod.make_mesh(mesh_shape, ("data", "model"), "cpu")
        rules = R.make_rules(cfg, mesh)
        params = rules.distribute(params, model.specs())
        specs = R.data_specs(cfg, ShapeConfig("s", S, B, "prefill"), mesh,
                             rules)
        act = activation_axes(cfg, mesh, R.batch_spec(mesh, B))
    extra = {k: put(k, v, specs.get(k)) for k, v in inp.items()
             if k.endswith("embeds")}
    out = []
    with activation_sharding(mesh, act), torch.no_grad():
        lg, cache = model.prefill(params, put("tokens", inp["tokens"],
                                              specs.get("tokens")),
                                  LIB, cache_len=W, **extra)
        out.append(_whole(lg))
        for s in range(STEPS):
            lg, cache = model.decode(params, put("tokens", inp["next"][s],
                                                 specs.get("tokens")),
                                     cache, LIB)
            out.append(_whole(lg))
    layout = {} if mesh_shape is None else {
        k: tuple(str(p) for p in getattr(cache, k).placements)
        for k in ("attn_k", "conv", "shared_k", "self_k", "cross_k")
        if getattr(cache, k, None) is not None}
    return np.stack(out), layout


#: the split softmax's cases: (ring slots, query position, window)
SPLIT = [(16, 11, None), (16, 37, None), (16, 37, 9), (12, 5, 4)]


def _split_inputs(W):
    rng = np.random.default_rng(W)
    q = rng.standard_normal((2, 4, 1, 8)).astype(np.float32)
    k = rng.standard_normal((2, 2, W, 8)).astype(np.float32)
    v = rng.standard_normal((2, 2, W, 8)).astype(np.float32)
    return q, k, v


def _split_cases(world):
    """Each rank's share of the split softmax over its slots, the slots
    split ``n`` ways over a 1-D mesh of this world."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    rank = torch.distributed.get_rank()
    out = {}
    for W, pos, window in SPLIT:
        q, k, v = (torch.from_numpy(a) for a in _split_inputs(W))
        n = W // world
        out[(W, pos, window)] = L.split_decode_attend(
            q, k[:, :, rank * n:(rank + 1) * n],
            v[:, :, rank * n:(rank + 1) * n], pos, window=window,
            scale=8 ** -0.5, ring=W, first=rank * n,
            groups=[(mesh, 0)]).numpy()
    return out


def _world(rank, world):
    torch.set_num_threads(1)
    out = {c: _serve(*c[:2], *c[2:]) for c in CASES}
    out["split"] = _split_cases(world)
    return out


@pytest.fixture(scope="module")
def world():
    return mesh_mod.spawn(_world, 4, timeout=TIMEOUT)


def _groups(arch, mesh, B):
    cfg = configs.get_smoke(arch)
    return R.axis_size(mesh_mod.mesh_shape(mesh, ("data", "model")),
                       R.batch_spec(mesh_mod.mesh_shape(
                           mesh, ("data", "model")), B)) if cfg.moe else 1


@pytest.mark.parametrize("case", CASES, ids=lambda c: (
    f"{c[0]}-{c[1][0]}x{c[1][1]}-B{c[2]}"))
def test_sharded_serve_matches_one_rank(world, case):
    arch, mesh, B, S, W = case
    want, _ = _serve(arch, None, B, S, W, _groups(arch, mesh, B))
    for r in world:                     # every rank gathered the same
        got, layout = r[case]
        assert got.shape == want.shape
        err = np.abs(got - want).max()
        assert err <= TOL * np.abs(want).max(), (case, err)
    if B == 1 or arch == "glm4-9b":
        # the slots split: over data at B 1, over model where the kv heads
        # do not split
        key = "self_k" if "self_k" in layout else "attn_k"
        assert layout[key][0 if B == 1 else 1] == "S(3)", layout


@pytest.mark.parametrize("W,pos,window", SPLIT)
def test_split_softmax_equals_the_whole_buffer(world, W, pos, window):
    q, k, v = (torch.from_numpy(a) for a in _split_inputs(W))
    want = L.decode_attend(q, k, v, pos, window=window,
                           scale=8 ** -0.5).numpy()
    for r in world:
        got = r["split"][(W, pos, window)]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
