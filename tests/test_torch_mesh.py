"""Training on several ranks: the port's counterpart of
``tests/test_distributed.py``.

Worlds of 2, 3 and 8 ranks are spawned on the CPU (gloo over a
``FileStore``, one thread a rank: ``launch/mesh.spawn``), each with its
own time limit, so a hang fails its test and not the suite.  The
reference's sharded step cannot be run on JAX 0.9 (its
``lax.scan`` over batch-sharded microbatches and its embedding gather
fail), so a sharded step is held against the port's one-rank step on
the same state and the same rows; that step is held against the
reference's in ``test_torch_train.py``.

* An MoE step is held against a one-rank step with the same dispatch
  groups (G = the data degree, through the activation context) and the
  same rows in each microbatch (each rank cuts its own rows, so
  microbatch i holds the i-th block of every batch shard).
* f32: the step-1 gradient of every leaf within ``GRAD_TOL`` of the
  one-rank gradient's max |g|, the losses of 3 steps within
  ``LOSS_TOL`` relative; at the model's dtype (bf16) the reference
  test's 5e-2 on the loss.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api, configs, obs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import registry
from repro_torch.parallel import rules as R, spmd
from repro_torch.parallel.ctx import activation_axes, activation_sharding
from repro_torch.train import checkpoint as ck
from repro_torch.train import data as D
from repro_torch.train import loop as TL

GRAD_TOL = 1e-5          # of the one-rank gradient's max |g|, per leaf
LOSS_TOL = 1e-4          # relative, f32
BF16_LOSS_TOL = 5e-2     # relative (the reference's test)
TIMEOUT = 240.0          # seconds, a spawned world
B, S, STEPS, SEED = 4, 32, 3, 11
TRAIN = api.named_policy("library").replace(kernels="library")


def _cfg(arch, dtype):
    return dataclasses.replace(configs.get_smoke(arch), dtype=dtype)


def _grads(model, tc, st, mb):
    """The first microbatch's gradients at ``st`` (full numpy arrays)."""
    pc = TL.cast_params_for_compute(st["params"], model.cfg)
    loss, _ = TL.make_loss_fn(model, tc, TRAIN)(pc, mb)
    names, leaves = zip(*pc.named_parameters())
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {n: (g.full_tensor() if spmd.is_dtensor(g) else g).float()
            .numpy() for n, g in zip(names, gs) if g is not None}


def _sharded_run(arch, shape, accum, dtype, with_grads=True):
    """3 steps on a ``shape`` mesh over this world: (losses, step-1
    gradients (rank 0 only), the number of batch shards)."""
    cfg = _cfg(arch, dtype)
    model = registry.build(cfg)
    mesh = mesh_mod.make_mesh(shape, ("data", "model"), "cpu")
    rules = R.make_rules(cfg, mesh)
    tc = TL.TrainConfig(accum_steps=accum)
    step = TL.make_train_step(model, tc, TRAIN)
    st = rules.distribute(
        TL.init_train_state(model, torch.Generator().manual_seed(0), "cpu"),
        TL.train_state_specs(model))
    data = D.SyntheticTokens(cfg.vocab, S, B, seed=SEED)
    dpl = R.data_shardings(cfg, ShapeConfig("t", S, B, "train"), mesh,
                           rules)
    host, hosts = spmd.shard_coordinate(mesh, dpl["tokens"])
    losses, grads = [], None
    with activation_sharding(mesh, activation_axes(
            cfg, mesh, R.batch_spec(mesh, B))):
        for s in range(STEPS):
            gb = D.make_global_batch(D.to_device(
                data.batch(s, host=host, num_hosts=hosts), "cpu"), mesh, dpl)
            if s == 0 and with_grads:
                grads = _grads(model, tc, st, TL._split_micro(gb, accum)[0])
            st, m = step(st, gb)
            losses.append(float(m["loss"]))
    rank0 = torch.distributed.get_rank() == 0
    return losses, grads if rank0 else None, hosts


def _one_rank(arch, accum, dtype, hosts, groups):
    """The same 3 steps on one rank: the global batch of every step is
    the batch shards' rows reordered so that a contiguous cut into
    ``accum`` microbatches gives each microbatch the rows the sharded
    step's ranks cut; the MoE layer in ``groups`` dispatch groups."""
    cfg = _cfg(arch, dtype)
    model = registry.build(cfg)
    tc = TL.TrainConfig(accum_steps=accum)
    step = TL.make_train_step(model, tc, TRAIN)
    st = TL.init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    data = D.SyntheticTokens(cfg.vocab, S, B, seed=SEED)
    per = B // hosts // accum
    losses, grads = [], None
    one = mesh_mod.mesh_shape((1, 1), ("data", "model"))
    with activation_sharding(one, {"_moe_shards": groups}):
        for s in range(STEPS):
            rows = [data.batch(s, host=h, num_hosts=hosts)
                    for h in range(hosts)]
            # where accum does not divide a shard's rows the sharded step
            # gathers the batch and cuts it whole (``_split_micro``)
            gb = D.to_device({k: np.concatenate(
                [rows[h][k][i * per:(i + 1) * per] for i in range(accum)
                 for h in range(hosts)] if per else
                [rows[h][k] for h in range(hosts)]) for k in rows[0]},
                "cpu")
            if s == 0:
                grads = _grads(model, tc, st, TL._split_micro(gb, accum)[0])
            st, m = step(st, gb)
            losses.append(float(m["loss"]))
    return losses, grads


def _assert_equal_steps(got, want, dtype):
    (gl, gg, _), (wl, wg) = got, want
    tol = LOSS_TOL if dtype == "float32" else BF16_LOSS_TOL
    for a, b in zip(gl, wl):
        assert abs(a - b) <= tol * abs(b), (gl, wl)
    if dtype != "float32" or gg is None:
        return
    assert set(gg) == set(wg)
    for n, g in wg.items():
        err = np.abs(gg[n] - g).max()
        assert err <= GRAD_TOL * np.abs(g).max(), (n, err)


def _groups(arch, hosts):
    return hosts if configs.get_smoke(arch).moe else 1


# --------------------------------------------------------------------------
# World A: 8 ranks, the 2 x 4 mesh.
# --------------------------------------------------------------------------

def _routes_and_comms():
    """One ``mm`` of olmo-smoke's FSDP + TP weight on the 2 x 4 mesh
    under ``auto``: the local (M, N, K) the router saw, and the
    collectives (kind -> count and the gathered shapes)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.models.common import mm
    mesh = mesh_mod.make_mesh((2, 4), ("data", "model"), "cpu")
    g = torch.Generator().manual_seed(3)
    x = spmd.distribute(torch.randn(4, 32, 64, generator=g), mesh,
                        (Shard(0), Replicate()))
    w = spmd.distribute(torch.randn(64, 128, generator=g), mesh,
                        (Shard(0), Shard(1)))
    obs.ROUTES.reset()
    with CommDebugMode() as cm:
        y = mm(x, w, api.named_policy("auto"))
    dims = sorted({k[3] for k in obs.ROUTES.hits if k[0] == "matmul"})
    counts = {str(k).split(".")[-1]: v
              for k, v in cm.get_comm_counts().items()}
    return {"dims": dims, "comms": counts,
            "placements": tuple(y.placements) == (Shard(0), Shard(2)),
            "close": bool(torch.allclose(
                y.full_tensor(), torch.matmul(x.full_tensor(),
                                              w.full_tensor()),
                rtol=1e-5, atol=1e-5))}


def _restore_check(path, shape, arch):
    """Restore the checkpoint at ``path`` onto a ``shape`` mesh: whether
    every local shard equals its slice of the full array to the bit, and
    the restored state's step."""
    cfg = configs.get_smoke(arch)
    model = registry.build(cfg)
    mesh = mesh_mod.make_mesh(shape, ("data", "model"), "cpu")
    rules = R.make_rules(cfg, mesh)
    cp = ck.Checkpointer(path)
    tree, _ = cp.restore(shardings=rules.shardings(
        TL.train_state_specs(model)))
    full, _ = cp.restore()
    bad = []
    for (name, got), (_, want) in zip(ck._flatten(tree), ck._flatten(full)):
        if spmd.is_dtensor(got):
            loc = got.to_local().numpy()
            ref = spmd.local_slice(want, got.device_mesh, got.placements)
        else:
            loc, ref = np.asarray(got), want
        if loc.dtype != ref.dtype or loc.tobytes() != ref.tobytes():
            bad.append(name)
    state = TL.state_from_numpy(tree, cfg, "cpu")
    back = TL.state_to_numpy(state, cfg)
    for (name, got), (_, want) in zip(ck._flatten(back), ck._flatten(full)):
        if np.asarray(got).tobytes() != np.asarray(want).tobytes():
            bad.append("state:" + name)
    return {"bad": bad, "step": state["step"],
            "dtensor": spmd.is_dtensor(state["params"].embed)}


def _world_a(rank, world, ckpt_dir, jax_dir, launch_dir):
    from repro_torch.launch import train as train_mod
    out = {}
    for dtype in ("float32", "bfloat16"):
        out[dtype] = _sharded_run("moonshot-v1-16b-a3b", (2, 4), 2, dtype,
                                  with_grads=dtype == "float32")
    out["mm"] = _routes_and_comms()
    # a checkpoint of a 2 x 4 state (its full arrays, written by rank 0)
    cfg = configs.get_smoke("moonshot-v1-16b-a3b")
    model = registry.build(cfg)
    mesh = mesh_mod.make_mesh((2, 4), ("data", "model"), "cpu")
    st = R.make_rules(cfg, mesh).distribute(
        TL.init_train_state(model, torch.Generator().manual_seed(5), "cpu"),
        TL.train_state_specs(model))
    cp = ck.Checkpointer(ckpt_dir)
    host = TL.state_to_numpy(st, cfg)
    cp.save(1, host, extra={"data_step": 1}, async_=True)
    cp.wait()
    out["saved"] = host if rank == 0 else None
    out["jax"] = _restore_check(jax_dir, (2, 4), "moonshot-v1-16b-a3b")
    # the launcher's _run on this mesh: 3 steps; 2 with a checkpoint a
    # step, resumed to 3; and --production-mesh in this world
    def run(*argv):
        args = train_mod.build_args(
            ["--arch", "olmo-1b", "--smoke", "--batch", "4", "--seq", "16",
             "--device", "cpu", "--log-every", "100", *argv])
        return train_mod._run(args, configs.get_smoke("olmo-1b"), "cpu",
                              mesh)
    whole = run("--steps", "3")
    res = run("--steps", "2", "--ckpt-dir", launch_dir, "--ckpt-every", "1")
    out["launch"] = {k: res[k] for k in ("loss", "final_step")}
    out["launch"]["steps"] = ck.Checkpointer(launch_dir).all_steps()
    resumed = run("--steps", "3", "--ckpt-dir", launch_dir, "--resume")
    out["resume"] = ([h["step"] for h in resumed["history"]],
                     resumed["loss"], whole["loss"])
    try:
        train_mod.run(train_mod.build_args(
            ["--arch", "olmo-1b", "--smoke", "--device", "cpu",
             "--production-mesh"]))
        out["production"] = "no error"
    except ValueError as e:
        out["production"] = str(e)
    return out


def _jax_checkpoint(path):
    """The JAX package's moonshot-smoke train state, written by its own
    Checkpointer."""
    import jax
    from repro import configs as jconfigs
    from repro.models import registry as jregistry
    from repro.train import checkpoint as jck, loop as JTL
    jm = jregistry.build(jconfigs.get_smoke("moonshot-v1-16b-a3b"))
    jst = JTL.init_train_state(jm, jax.random.PRNGKey(7))
    jck.Checkpointer(path).save(3, jst, extra={"data_step": 3})


@pytest.fixture(scope="module")
def world_a(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    dirs = [str(root / n) for n in ("ckpt", "jax", "launch")]
    _jax_checkpoint(dirs[1])
    outs = mesh_mod.spawn(_world_a, 8, *dirs, timeout=TIMEOUT)
    return outs, dirs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moonshot_2x4_accum2_matches_one_rank(world_a, dtype):
    """The configuration whose reference run fails on JAX 0.9: moonshot
    smoke on 2 x 4 (its 8 experts on the 4-way model axis: EP), 2
    microbatches, 3 steps, against one rank with 2 dispatch groups and
    the same microbatch rows."""
    outs, _ = world_a
    got = outs[0][dtype]
    assert got[2] == 2
    assert all(o[dtype][0] == got[0] for o in outs)    # one loss everywhere
    want = _one_rank("moonshot-v1-16b-a3b", 2, dtype, got[2],
                     _groups("moonshot-v1-16b-a3b", got[2]))
    _assert_equal_steps(got, want, dtype)


def test_routed_gemm_on_local_shards_gathers_the_weight(world_a):
    """``mm`` on DTensors: the router sees each rank's (M, N, K) = (2·32,
    128/4, 64), the weight is all-gathered over data (one all-gather,
    the weight's) and never the activation, and the output is laid out
    (batch, N/model)."""
    outs, _ = world_a
    for o in outs:
        mm_ = o["mm"]
        assert mm_["dims"] == [(2, 32, 64, 32)], mm_
        assert mm_["comms"] == {"all_gather_into_tensor": 1}, mm_
        assert mm_["placements"]
        assert mm_["close"]


def test_checkpoint_2x4_restores_on_1x1(world_a):
    """Rank 0 wrote the 2 x 4 state's full arrays; one rank restores
    them, state and all, equal to the bit."""
    outs, (ckpt_dir, _, _) = world_a
    saved = outs[0]["saved"]
    cfg = configs.get_smoke("moonshot-v1-16b-a3b")
    tree, extra = ck.Checkpointer(ckpt_dir).restore()
    assert extra == {"data_step": 1}
    back = TL.state_to_numpy(TL.state_from_numpy(tree, cfg, "cpu"), cfg)
    for (n, a), (_, b) in zip(ck._flatten(back), ck._flatten(saved)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), n
    one = TL.state_to_numpy(TL.init_train_state(
        registry.build(cfg), torch.Generator().manual_seed(5), "cpu"), cfg)
    for (n, a), (_, b) in zip(ck._flatten(one), ck._flatten(saved)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), n


def test_jax_checkpoint_restores_on_2x4(world_a):
    """A checkpoint the JAX package wrote, restored shard by shard onto
    2 x 4: every local shard equals its slice of the reference's array,
    and the state built from the shards carries them back whole."""
    outs, _ = world_a
    for o in outs:
        assert o["jax"] == {"bad": [], "step": 0, "dtensor": True}


def test_launcher_trains_on_2x4(world_a):
    """``launch/train.py``'s ``_run`` on the 2 x 4 mesh: 2 steps, one
    loss on every rank, a checkpoint a step (rank 0 writes); resumed
    from it (each rank reading its shards) to step 3, the loss of 3
    uninterrupted steps to the bit; and ``--production-mesh`` in this
    world of 8 raises, naming 256."""
    outs, _ = world_a
    losses = {o["launch"]["loss"] for o in outs}
    assert len(losses) == 1 and np.isfinite(losses.pop())
    assert {o["launch"]["final_step"] for o in outs} == {2}
    assert outs[0]["launch"]["steps"] == [1, 2]
    for o in outs:
        steps, got, want = o["resume"]
        assert steps == [2] and got == want
    for o in outs:
        assert "needs a world of 256 ranks; this one has 8" in \
            o["production"]


# --------------------------------------------------------------------------
# World B: 8 ranks, 4 x 2, restoring the 2 x 4 checkpoint.
# --------------------------------------------------------------------------

def _world_b(rank, world, ckpt_dir):
    return _restore_check(ckpt_dir, (4, 2), "moonshot-v1-16b-a3b")


def test_checkpoint_2x4_restores_on_4x2(world_a):
    outs, (ckpt_dir, _, _) = world_a
    for o in mesh_mod.spawn(_world_b, 8, ckpt_dir, timeout=TIMEOUT):
        assert o == {"bad": [], "step": 0, "dtensor": True}


# --------------------------------------------------------------------------
# World C: 2 ranks, 1 x 2 (TP; the mamba mixer split by heads, zamba2's
# shared attention block) and 2 x 1 (FSDP + DP); world D: 1 x 3.
# --------------------------------------------------------------------------

C_CASES = [(a, s) for a in ("olmo-1b", "mamba2-780m")
           for s in ((1, 2), (2, 1))] + [("zamba2-7b", (1, 2))]
#: moonshot on 2 x 1 with 4 microbatches: a shard's 2 rows do not split
#: 4 ways, so each microbatch is one row cut from the gathered batch, and
#: its 2 dispatch groups split that row's sequence
C_GATHERED = ("moonshot-v1-16b-a3b", (2, 1), 4)


def _world_c(rank, world):
    out = {(a, s): _sharded_run(a, s, 1, "float32") for a, s in C_CASES}
    out[C_GATHERED] = _sharded_run(*C_GATHERED, "float32")
    return out


@pytest.fixture(scope="module")
def world_c():
    return mesh_mod.spawn(_world_c, 2, timeout=TIMEOUT)


@pytest.mark.parametrize("arch,shape", C_CASES)
def test_smoke_on_two_ranks_matches_one_rank(world_c, arch, shape):
    got = world_c[0][(arch, shape)]
    want = _one_rank(arch, 1, "float32", got[2], _groups(arch, got[2]))
    _assert_equal_steps(got, want, "float32")


def test_moe_groups_within_a_sequence_match_one_rank(world_c):
    """The MoE output of dispatch groups that split a sequence (a one-row
    microbatch in 2 groups) is gathered back to the whole rows before it
    is reshaped to the batch; the step equals one rank's in the same
    groups."""
    arch, _, accum = C_GATHERED
    got = world_c[0][C_GATHERED]
    want = _one_rank(arch, accum, "float32", got[2], got[2])
    _assert_equal_steps(got, want, "float32")


def _world_d(rank, world):
    cfg = configs.get_smoke("moonshot-v1-16b-a3b")
    mesh = mesh_mod.make_mesh((1, 3), ("data", "model"), "cpu")
    fallbacks = R.make_rules(cfg, mesh).fallbacks
    return _sharded_run("moonshot-v1-16b-a3b", (1, 3), 1, "float32"), \
        fallbacks


def test_moonshot_1x3_fallbacks_replicate():
    """Neither moonshot-smoke's 8 experts nor its 4 heads divide a 3-way
    model axis: the rules replicate them (``Rules.report`` lists it), and
    the step still equals one rank's."""
    got, fallbacks = mesh_mod.spawn(_world_d, 3, timeout=TIMEOUT)[0]
    assert {"heads", "kv_heads", "experts"} <= set(fallbacks)
    want = _one_rank("moonshot-v1-16b-a3b", 1, "float32", got[2], 1)
    _assert_equal_steps(got, want, "float32")


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        mesh_mod.spawn(_fail_on_rank_1, 2, timeout=TIMEOUT)
    assert not torch.distributed.is_initialized()


def _fail_on_rank_1(rank, world):
    if rank == 1:
        raise ValueError("boom")
    return rank


def test_shard_helpers():
    """``local_offset`` / ``local_slice`` on a fake 2 x 4 world (rank 0's
    view), and ``param_spec`` of module parameter names."""
    ms = mesh_mod.mesh_shape((2, 4), ("data", "model"))
    cfg = configs.get_smoke("olmo-1b")
    specs = registry.build(cfg).specs()
    assert R.param_spec(specs, "blocks.1.attn.wq") == ("embed", "heads")
    assert R.param_spec(specs, "embed") == ("vocab", None)
    assert R.make_rules(cfg, ms).spec(("embed", "heads")) == \
        ("data", "model")
    from repro_torch.launch.dryrun import fake_world
    from torch.distributed.tensor import Replicate, Shard
    with fake_world(ms) as dm:
        a = np.arange(8 * 12).reshape(8, 12)
        assert spmd.local_offset(a.shape, dm, (Shard(0), Shard(1))) == \
            (0, 0)
        assert spmd.local_slice(a, dm, (Replicate(), Shard(0))).shape == \
            (2, 12)
        assert spmd.shard_coordinate(dm, (Shard(0), Replicate())) == (0, 2)
    assert not torch.distributed.is_initialized()
