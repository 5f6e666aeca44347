"""The port's sharding layer (``parallel/``, ``launch/mesh.py``), its
parameter specs and the MoE layer's per-data-shard branch, against the
JAX package's.

The rules read only a mesh's axis names and sizes, so the reference runs
on ``jax.sharding.AbstractMesh`` and the port on ``mesh.mesh_shape`` at
the four meshes 1 x 1, 2 x 4, 16 x 16 and 2 x 16 x 16: no devices and no
process group.  The per-device argument bytes of the reference are
worked out as its dry run's compile would see them, from its own
``model.specs()``, ``make_rules``, ``train_state_specs``,
``cache_shardings`` and ``jax.eval_shape`` (``shard_shape`` of each
leaf's NamedSharding), with no compile.  The port keeps a cache's ``pos``
on the host, where the reference holds a 4-byte int32 device scalar: the
caches may differ by exactly those 4 bytes, and by nothing else.

The MoE branch runs in f32 at ``test_torch_moe.py``'s tolerances, the
reference under its activation context on a 1 x 1 CPU mesh.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.launch import mesh as jmesh
from repro.models import layers as JL, registry as jregistry
from repro.models.common import XLA
from repro.parallel import ctx as jctx, rules as JR
from repro.train import loop as jloop
from repro_torch import api, configs
from repro_torch.configs import base
from repro_torch.launch import dryrun, mesh as mesh_mod
from repro_torch.models import layers as L, lm, registry
from repro_torch.models.common import STRUCTS
from repro_torch.parallel import ctx, rules as R
from repro_torch.train import loop as TL

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
LIBRARY = api.named_policy("library")
#: the cache tensors' bytes the port does not hold on the device: the
#: reference's int32 ``pos`` scalar
POS_BYTES = 4


def _meshes(shape, axes):
    return AbstractMesh(shape, axes), mesh_mod.mesh_shape(shape, axes)


def _norm_axis(ax):
    """A PartitionSpec entry with 1-tuples unwrapped (P("a") == P(("a",)))."""
    if isinstance(ax, tuple):
        return ax[0] if len(ax) == 1 else ax
    return ax


def _norm(spec):
    """A spec (P or the port's tuple) as a tuple, trailing Nones dropped."""
    t = [_norm_axis(a) for a in tuple(spec)]
    while t and t[-1] is None:
        t.pop()
    return tuple(t)


def _placements(mesh_axes, spec):
    """The DTensor placements a reference PartitionSpec means, worked out
    here independently of the port: mesh axis j is Shard(d) where spec
    dim d names it, else Replicate."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, ax in enumerate(tuple(spec)):
        for a in (ax,) if isinstance(ax, str) else (ax or ()):
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh_axes)


def _leaves(tree, path=()):
    """(path, leaf) over a spec tree; tuples are leaves, None absent."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


# -- rules, placements, activation axes --------------------------------------

def test_arch_ids_and_shapes_match_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for a in configs.ARCH_IDS:
        for s in base.SHAPES:
            assert base.shape_applicable(configs.get_config(a),
                                         base.SHAPES[s]) == \
                jbase.shape_applicable(jconfigs.get_config(a),
                                       jbase.SHAPES[s]), (a, s)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_rules_match_reference(arch, mesh):
    """Table, fallbacks, report, every parameter's spec and placements,
    the batch spec, data and cache layouts and the activation axes, FSDP
    on and off."""
    jm, tm = _meshes(*mesh)
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    specs = registry.build(cfg).specs()
    assert specs == jregistry.build(jcfg).specs()
    for fsdp in (True, False):
        jr = JR.make_rules(jcfg, jm, fsdp=fsdp)
        tr = R.make_rules(cfg, tm, fsdp=fsdp)
        assert tr.table == jr.table and tr.fallbacks == jr.fallbacks
        assert tr.report() == jr.report()
        for path, logical in _leaves(specs):
            want = jr.spec(logical)
            assert _norm(tr.spec(logical)) == _norm(want), (path, logical)
            assert tr.placements(logical) == _placements(mesh[1], want), path
        for shape in base.SHAPES.values():
            jshape = jbase.SHAPES[shape.name]
            assert R.batch_spec(tm, shape.global_batch) == \
                JR.batch_spec(jm, shape.global_batch)
            jd = JR.data_shardings(jcfg, jshape, jm, jr)
            td = R.data_shardings(cfg, shape, tm, tr)
            assert set(td) == set(jd)
            for k in jd:
                assert td[k] == _placements(mesh[1], jd[k].spec), k
            jc = JR.cache_shardings(jcfg, jshape, jm, jr)
            tc = R.cache_shardings(cfg, shape, tm, tr)
            assert {k: _norm(v) for k, v in tc.items()} == \
                {k: _norm(v) for k, v in jc.items()}
            b = JR.batch_spec(jm, shape.global_batch)
            assert ctx.activation_axes(cfg, tm, b) == \
                jctx.activation_axes(jcfg, jm, b)
    assert mesh_mod.batch_axes(tm) == jmesh.batch_axes(jm)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_match_reference_tree(arch, smoke):
    """``Model.specs()`` and ``train_state_specs`` are the reference's
    trees, and the specs are shaped like ``params_to_numpy``'s tree of the
    port's module (same keys, None where a parameter is absent)."""
    get, jget = (configs.get_smoke, jconfigs.get_smoke) if smoke else \
        (configs.get_config, jconfigs.get_config)
    model, jmodel = registry.build(get(arch)), jregistry.build(jget(arch))
    assert model.specs() == jmodel.specs()
    assert TL.train_state_specs(model) == jloop.train_state_specs(jmodel)
    cfg = get(arch)
    structs = TL._family(cfg).params_to_numpy(
        model.init(torch.Generator(), "meta"), cfg, STRUCTS)
    got = [(p, len(s)) for p, s in _leaves(model.specs())]
    assert got == [(p, len(s.shape)) for p, s in _leaves(structs)]


def test_local_shape_and_uneven_splits():
    tm = mesh_mod.mesh_shape((2, 16, 16), ("pod", "data", "model"))
    rules = R.make_rules(configs.get_config("olmo-1b"), tm)
    assert rules.local_shape(("vocab", None), (50304, 2048)) == (3144, 2048)
    assert rules.local_shape(("layers", "embed", "mlp"), (16, 2048, 8192)) \
        == (16, 128, 512)
    assert R.spec_local_shape(tm, (("pod", "data"), None), (256, 7)) == \
        (8, 7)
    with pytest.raises(ValueError, match="does not split"):
        R.spec_local_shape(tm, ("data",), (250,))
    with pytest.raises(ValueError, match="axis order"):
        R.spec_placements(tm, (("data", "pod"),))
    with pytest.raises(ValueError, match="twice"):
        R.spec_placements(tm, ("data", "data"))


# -- per-device argument bytes -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_structs(arch):
    """The reference's train state and serving params as ShapeDtypeStructs."""
    model = jregistry.build(jconfigs.get_config(arch))
    state = jax.eval_shape(
        lambda: jloop.init_train_state(model, jax.random.PRNGKey(0)))
    params = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16)
        if jnp.issubdtype(s.dtype, jnp.floating) else s,
        jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    return model, state, params


def _local_bytes(structs, shardings):
    return sum(math.prod(sh.shard_shape(s.shape)) * s.dtype.itemsize
               for s, sh in zip(jax.tree.leaves(structs),
                                jax.tree.leaves(shardings)))


def _ref_inputs(cfg, shape):
    """The reference dry run's ``input_specs`` (not imported: that module
    sets XLA_FLAGS for 512 host devices when it is imported)."""
    B, S, d = shape.global_batch, shape.seq_len, cfg.d_model
    if shape.kind == "decode":
        return {"tokens": ((B, 1), 4)}
    text = S - cfg.frontend_tokens if cfg.frontend == "vision" else S
    out = {"tokens": ((B, text), 4)}
    if shape.kind == "train":
        out["labels"] = ((B, text), 4)
    if cfg.frontend == "vision":
        out["prefix_embeds"] = ((B, cfg.frontend_tokens, d), 2)
    if cfg.frontend == "audio":
        out["src_embeds"] = ((B, S, d), 2)
    return out


def ref_argument_bytes(arch, shape_name, mesh):
    """The reference's per-device argument bytes by group."""
    from jax.sharding import NamedSharding
    jcfg, shape = jconfigs.get_config(arch), jbase.SHAPES[shape_name]
    model, state, params = _ref_structs(arch)
    rules = JR.make_rules(jcfg, mesh)
    dsh = JR.data_shardings(jcfg, shape, mesh, rules)
    out = {"batch": sum(math.prod(dsh[k].shard_shape(s)) * n
                        for k, (s, n) in _ref_inputs(jcfg, shape).items())}
    if shape.kind == "train":
        out["state"] = _local_bytes(state, rules.tree_shardings(
            jloop.train_state_specs(model)))
        return out
    out["params"] = _local_bytes(params, rules.tree_shardings(model.specs()))
    if shape.kind == "decode":
        cache = jax.eval_shape(lambda: model.init_cache(
            shape.global_batch, shape.seq_len, jnp.bfloat16))
        cs = JR.cache_shardings(jcfg, shape, mesh, rules)
        out["cache"] = sum(
            math.prod(NamedSharding(mesh, cs.get(f.name, P()))
                      .shard_shape(v.shape)) * v.dtype.itemsize
            for f in dataclasses.fields(cache)
            for v in [getattr(cache, f.name)] if v is not None)
    return out


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_argument_bytes_match_reference(arch):
    """Every applicable shape on the two production meshes: the port's
    dry-run bytes equal the reference's, group by group, the cache short
    by the reference's device ``pos`` alone."""
    cfg = configs.get_config(arch)
    for mesh in MESHES[2:]:
        jm, tm = _meshes(*mesh)
        for name, shape in base.SHAPES.items():
            if not base.shape_applicable(cfg, shape)[0]:
                continue
            want = ref_argument_bytes(arch, name, jm)
            got, port = dryrun.argument_bytes(cfg, shape, tm)
            if "cache" in want:
                assert got["cache"] == want["cache"] - POS_BYTES
                got = dict(got, cache=want["cache"])
            assert got == want, (arch, name, mesh)
            assert set(port) == set(got)


@pytest.mark.parametrize("arch,shape,group,want", [
    ("olmo-1b", "train_4k", "state", 127_795_204),
    ("olmo-1b", "train_4k", "batch", 524_288),
    ("moonshot-v1-16b-a3b", "train_4k", "state", 1_791_641_092),
    ("moonshot-v1-16b-a3b", "train_4k", "batch", 524_288),
    ("olmo-1b", "decode_32k", "params", 21_299_200),
    ("olmo-1b", "decode_32k", "cache", 2_147_483_652),
    ("moonshot-v1-16b-a3b", "decode_32k", "params", 298_606_848),
    ("moonshot-v1-16b-a3b", "decode_32k", "cache", 6_442_450_948)])
def test_reference_figures_on_the_16x16_mesh(arch, shape, group, want):
    """The four cells' figures, per device on 16 x 16: the reference's,
    and the port's (the cache 4 bytes short: ``pos`` on the host)."""
    jm, tm = _meshes(*MESHES[2])
    assert ref_argument_bytes(arch, shape, jm)[group] == want
    got = dryrun.argument_bytes(configs.get_config(arch),
                                base.SHAPES[shape], tm)[0][group]
    assert got == want - (POS_BYTES if group == "cache" else 0)


# -- the MoE per-data-shard branch ---------------------------------------------

@functools.lru_cache(maxsize=None)
def _moe_pair(arch):
    """(port cfg, JAX cfg, JAX model, JAX params, port params), f32 smoke."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype="float32")
    jmodel = jregistry.build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    tparams = lm.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    return cfg, jcfg, jmodel, jparams, tparams


def _both_ctx(G):
    """The two packages' activation contexts with G MoE dispatch groups,
    on 1 x 1 meshes (a CPU device mesh for the reference)."""
    jm = jmesh.make_host_mesh()
    tm = mesh_mod.mesh_shape((1, 1), ("data", "model"))
    axes = {"_moe_shards": G, "moe_group": None}
    return jm, jctx.activation_sharding(jm, axes), \
        ctx.activation_sharding(tm, axes)


@pytest.mark.parametrize("arch,G", [("moonshot-v1-16b-a3b", 2),
                                    ("moonshot-v1-16b-a3b", 4),
                                    ("mixtral-8x22b", 4)])
def test_moe_shards_match_reference(arch, G):
    """One MoE layer on 2 x 16 tokens split into G shards: outputs, the
    per-shard slot maps and gates, the mean aux (mixtral at G 2 through
    ``forward_train`` below)."""
    cfg, jcfg, _jm, jparams, tparams = _moe_pair(arch)
    x = np.random.RandomState(G).randn(2, 16, cfg.d_model).astype(
        np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"])
    tp = tparams.blocks[0].moe
    T = 32 // G
    C = L._capacity(T, cfg.moe)
    xg = x.reshape(G, T, -1)

    def ref(p, x):
        return JL.moe(p, x, XLA, jcfg), jax.vmap(
            lambda xs: JL._moe_dispatch(p["router"], xs, jcfg, C))(
                x.reshape(G, T, -1))
    jmesh_, jc, tc = _both_ctx(G)
    with jmesh_, jc:
        (yj, auxj), (jbuf, (jslot, jtop), jaux) = jax.jit(ref)(
            jp, jnp.asarray(x))
    with tc:
        assert ctx.moe_shard_count() == G
        yt, auxt = L.moe(tp, torch.from_numpy(x), LIBRARY, cfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-4)
    tbuf, (tslot, ttop), taux = L._moe_dispatch_groups(
        tp.router, torch.from_numpy(xg), cfg, C)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_allclose(ttop.numpy(), np.asarray(jtop), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=1e-4)


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mixtral-8x22b"])
def test_forward_train_under_shards_matches_reference(arch, G):
    cfg, jcfg, jmodel, jparams, tparams = _moe_pair(arch)
    toks = np.random.RandomState(7).randint(0, cfg.vocab, (2, 16))
    jmesh_, jc, tc = _both_ctx(G)
    with jmesh_, jc:
        want, jaux = jax.jit(lambda p, t: jmodel.forward_train(
            p, {"tokens": t}, XLA))(jparams, jnp.asarray(toks, jnp.int32))
    with tc:
        got, aux = registry.build(cfg).forward_train(
            tparams, torch.from_numpy(toks), LIBRARY)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("B,S,G", [(1, 24, 2),     # 12-token shards
                                   (1, 20, 3)])    # 20 % 3
def test_guard_falls_back_to_one_shard(B, S, G):
    """Where T = B*S does not split into G shards of a multiple of 8, the
    layer runs one dispatch over all T tokens, as without a context."""
    cfg, *_rest, tparams = _moe_pair("moonshot-v1-16b-a3b")
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    tp = tparams.blocks[0].moe
    want = L.moe(tp, x, LIBRARY, cfg)
    _jm, _jc, tc = _both_ctx(G)
    with tc:
        got = L.moe(tp, x, LIBRARY, cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- the context and the meshes ------------------------------------------------

def test_constrain_is_the_identity_on_one_rank():
    x = torch.randn(2, 3, 4)
    assert ctx.constrain(x, "batch", None, "mlp") is x
    assert ctx.constrain(None, "batch") is None
    assert ctx.moe_shard_count() == 1
    tm = mesh_mod.mesh_shape((16, 16), ("data", "model"))
    with ctx.activation_sharding(tm, {"batch": "data", "mlp": "model"}):
        assert ctx.constrain(x, "batch", None, "mlp") is x
        assert ctx.constrain(x, "batch") is x            # rank mismatch
        assert ctx.moe_shard_count() == 1


def test_host_mesh_on_gloo_and_torn_down():
    """The 1 x 1 mesh brings up a one-rank gloo group over an in-process
    store; a DTensor on it is laid out by ``constrain``; ``release_mesh``
    takes the group down."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    assert not dist.is_initialized()
    mesh = mesh_mod.make_host_mesh("cpu")
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1) and mesh.size() == 1
        assert R.axis_sizes(mesh) == {"data": 1, "model": 1}
        rules = R.make_rules(configs.get_config("olmo-1b"), mesh)
        assert rules.placements(("embed", "mlp")) == (Shard(0), Shard(1))
        x = DTensor.from_local(torch.randn(4, 6), mesh,
                               [Replicate(), Replicate()])
        with ctx.activation_sharding(mesh, {"batch": ("data",),
                                            "mlp": "model"}):
            y = ctx.constrain(x, "batch", "mlp")
        assert isinstance(y, DTensor)
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert torch.equal(y.full_tensor(), x.full_tensor())
    finally:
        mesh_mod.release_mesh()
    assert not dist.is_initialized()


def test_production_mesh_raises_on_a_world_of_one():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs a world of 256 ranks"):
        mesh_mod.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs a world of 512 ranks"):
        mesh_mod.make_production_mesh(multi_pod=True, device_type="cpu")
    assert mesh_mod.production_shape(True) == R.MeshShape(
        (2, 16, 16), ("pod", "data", "model"))
