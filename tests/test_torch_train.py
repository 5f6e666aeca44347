"""The port's training slice (``repro_torch.train``, ``launch/train.py``)
against the JAX package on the same numpy inputs, on the CPU (every
kernel wrapper takes its plain version there).

Tolerances, each stated where it is used:
* the schedule and AdamW are f32 arithmetic on both sides, taken in other
  orders: 1e-6 relative (``OPT_RTOL``);
* olmo-smoke's train step, JAX's ``make_train_step`` (jitted, no mesh,
  ``auto`` with ``kernels="xla"``: the IAAT Pallas kernel in interpret
  mode, the adjoint GEMMs through XLA) against the port's (``auto`` with
  ``kernels="library"``: the kernel's plain version, the adjoints through
  ``torch.matmul``), 3 steps (``STEP_TOL``).  In f32 both take the same
  products in other orders: loss and grad norm within 1e-5 relative
  (measured 2.4e-7).  Adam divides each gradient by its own size, so an
  element whose gradient is a rounding error from 0 moves by up to lr
  either way: the parameters are held by the update's norm, ||p - p_ref||
  / ||p_ref - p0||, within 1e-4 (measured 3.0e-5).  In bf16 each side
  rounds its projections to bf16 in other places (one step is 2^-8):
  loss within 2e-3 (measured 4.2e-4), grad norm within 3e-3 (6.5e-4),
  the update's norm within 0.15 (0.049).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.train import checkpoint as jck
from repro.train import data as jdata
from repro.train import loop as JTL
from repro.train import optimizer as jopt
from repro_torch import api, configs, obs
from repro_torch.kernels import flash_attention, grouped_gemm, iaat_gemm, ssd
from repro_torch.launch import train as train_mod
from repro_torch.models import encdec, lm, registry
from repro_torch.train import checkpoint as ck
from repro_torch.train import data as data_mod
from repro_torch.train import fault
from repro_torch.train import loop as TL
from repro_torch.train import optimizer as opt

KEY = jax.random.PRNGKey(0)
OPT_RTOL = 1e-6
#: (loss, grad norm, the update's norm) relative, per compute dtype
STEP_TOL = {"float32": (1e-5, 1e-5, 1e-4),
            "bfloat16": (2e-3, 3e-3, 0.15)}
#: the train policies: GEMMs input-aware, the kernels without a backward
#: on the library
J_TRAIN = japi.named_policy("auto").replace(kernels="xla")
T_TRAIN = api.Policy(backend="auto", kernels="library")
OC = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _leaves(tree):
    return jax.tree.leaves(tree)


def _update_rel(got, want, start) -> float:
    """||got - want|| / ||want - start|| over every leaf of three trees."""
    num = sum(float(((np.asarray(g, np.float64) - w) ** 2).sum())
              for g, w in zip(_leaves(got), _leaves(want)))
    den = sum(float(((np.asarray(w, np.float64) - s) ** 2).sum())
              for w, s in zip(_leaves(want), _leaves(start)))
    return (num / den) ** 0.5


def _family(cfg):
    return encdec if cfg.family in encdec.FAMILIES else lm


@pytest.fixture(autouse=True)
def _keep_the_default_policy():
    """The launcher installs its policy process-wide, as the reference's
    does; put the previous one back after each test."""
    prev = api.current_policy()
    yield
    api.install(prev)


def _port_state(tree, cfg):
    p = _family(cfg).params_from_numpy(tree, cfg, "cpu", torch.float32)
    return {"params": p, "opt": opt.init_opt_state(p), "step": 0}


# -- the optimizer ------------------------------------------------------------

@pytest.mark.parametrize("oc", [
    dict(peak_lr=1.0, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1),
    dict(peak_lr=3e-4, warmup_steps=20, decay_steps=10),
    dict(peak_lr=6e-4, warmup_steps=0, decay_steps=1000)])
def test_schedule_matches_reference(oc):
    for s in (0, 1, 9, 10, 11, 19, 20, 50, 99, 100, 500, 2000):
        want = float(jopt.schedule(jnp.asarray(s, jnp.int32),
                                   jopt.OptConfig(**oc)))
        got = opt.schedule(s, opt.OptConfig(**oc))
        assert abs(got - want) <= OPT_RTOL * abs(want), (s, got, want)


class _Leaves(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(v.copy()),
                                                requires_grad=False))


def test_adamw_update_matches_reference():
    """Five AdamW steps on leaves of rank 1, 2 and 3 (decayed from rank 2
    on), one of them clipped (grad norm 1e3 > clip 1), the norm reported
    before the clip, bias correction, the schedule's lr."""
    rng = np.random.RandomState(0)
    tree = {"a": rng.randn(3, 4).astype(np.float32),
            "b": rng.randn(5).astype(np.float32),
            "c": rng.randn(2, 3, 4).astype(np.float32)}
    c = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=6, clip_norm=1.0)
    jp = jax.tree.map(jnp.asarray, tree)
    jst = jopt.init_opt_state(jp)
    mod = _Leaves(tree)
    st = opt.init_opt_state(mod)
    for step in range(5):
        scale = 1e3 if step == 2 else 0.1
        g = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
             for k, v in tree.items()}
        jp, jst, jm = jopt.adamw_update(
            jp, jax.tree.map(jnp.asarray, g), jst,
            jnp.asarray(step, jnp.int32), jopt.OptConfig(**c))
        mod, st, m = opt.adamw_update(
            mod, {k: torch.from_numpy(v) for k, v in g.items()}, st, step,
            opt.OptConfig(**c))
        assert _rel(float(m["grad_norm"]), float(jm["grad_norm"])) <= OPT_RTOL
        assert _rel(m["lr"], float(jm["lr"])) <= OPT_RTOL
        if step == 2:
            assert float(m["grad_norm"]) > 100      # reported pre-clip
        for k in tree:
            for got, want in ((getattr(mod, k), jp[k]),
                              (getattr(st["m"], k), jst["m"][k]),
                              (getattr(st["v"], k), jst["v"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=OPT_RTOL * 10, atol=1e-9)


def test_adamw_reduces_loss_quadratic():
    mod = _Leaves({"w": np.asarray([3.0, -2.0], np.float32)})
    st = opt.init_opt_state(mod)
    c = opt.OptConfig(peak_lr=0.2, warmup_steps=1, decay_steps=1000,
                      weight_decay=0.0)
    for i in range(200):
        mod, st, _ = opt.adamw_update(mod, {"w": 2 * mod.w.detach()}, st, i,
                                      c)
    assert float(mod.w.abs().max()) < 0.05


def test_global_norm_is_f32_over_every_leaf():
    g = {"a": torch.full((4,), 3.0, dtype=torch.bfloat16),
         "b": torch.full((1,), 4.0)}
    assert float(opt.global_norm(g)) == pytest.approx(np.sqrt(36 + 16))


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("step,host,hosts", [(0, 0, 1), (7, 0, 1),
                                             (7, 1, 2), (123, 3, 4)])
def test_synthetic_tokens_bit_for_bit(step, host, hosts):
    for labels in (True, False):
        want = jdata.SyntheticTokens(vocab=777, seq_len=16, global_batch=8,
                                     seed=3, with_labels=labels)
        got = data_mod.SyntheticTokens(vocab=777, seq_len=16, global_batch=8,
                                       seed=3, with_labels=labels)
        a, b = got.batch(step, host, hosts), want.batch(step, host, hosts)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_memmap_tokens_bit_for_bit(tmp_path):
    arr = np.arange(10_000, dtype=np.int32) % 777
    path = tmp_path / "toks.bin"
    arr.tofile(path)
    want = jdata.MemmapTokens(str(path), seq_len=16, global_batch=4)
    got = data_mod.MemmapTokens(str(path), seq_len=16, global_batch=4)
    for step, host, hosts in ((0, 0, 1), (5, 0, 1), (9, 1, 2), (200, 0, 1)):
        a, b = got.batch(step, host, hosts), want.batch(step, host, hosts)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


def test_to_device_keeps_floats_and_widens_ids():
    b = data_mod.to_device({"tokens": np.zeros((2, 3), np.int32),
                            "prefix_embeds": np.ones((2, 1, 4), np.float32)},
                           "cpu")
    assert b["tokens"].dtype == torch.int64
    assert b["prefix_embeds"].dtype == torch.float32


# -- the train step -----------------------------------------------------------

def _olmo(dtype):
    jcfg = dataclasses.replace(jconfigs.get_smoke("olmo-1b"), dtype=dtype)
    cfg = dataclasses.replace(configs.get_smoke("olmo-1b"), dtype=dtype)
    return jcfg, cfg


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_train_step_matches_reference(dtype, accum):
    """olmo-smoke, 3 steps of B 4 x S 32 from the same parameters:
    loss, grad norm and lr each step, the parameters at the end."""
    jcfg, cfg = _olmo(dtype)
    jm = jregistry.build(jcfg)
    jst = JTL.init_train_state(jm, KEY)
    start = jax.tree.map(np.asarray, jst["params"])
    st = _port_state(start, cfg)
    jstep = jax.jit(JTL.make_train_step(
        jm, JTL.TrainConfig(opt=jopt.OptConfig(**OC), accum_steps=accum),
        J_TRAIN))
    tstep = TL.make_train_step(
        registry.build(cfg),
        TL.TrainConfig(opt=opt.OptConfig(**OC), accum_steps=accum), T_TRAIN)
    data = data_mod.SyntheticTokens(cfg.vocab, 32, 4, seed=0)
    tl, tg, tu = STEP_TOL[dtype]
    for s in range(3):
        b = data.batch(s)
        jst, jmet = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        st, m = tstep(st, data_mod.to_device(b, "cpu"))
        assert st["step"] == s + 1
        assert _rel(float(m["loss"]), float(jmet["loss"])) <= tl
        assert _rel(float(m["grad_norm"]), float(jmet["grad_norm"])) <= tg
        assert _rel(m["lr"], float(jmet["lr"])) <= OPT_RTOL
    got = lm.params_to_numpy(st["params"], cfg)
    want = jax.tree.map(np.asarray, jst["params"])
    assert _update_rel(got, want, start) <= tu
    for name in ("m", "v"):
        assert _update_rel(lm.params_to_numpy(st["opt"][name], cfg),
                           jax.tree.map(np.asarray, jst["opt"][name]),
                           jax.tree.map(np.zeros_like, start)) <= tu


def test_working_copy_follows_the_documented_cast_rule():
    """Matmul, expert and embedding weights and a mamba mixer's conv_w
    (rank 2) go to the compute dtype; per-layer vectors and the router
    stay f32; every working leaf requires grad, the master none."""
    for arch in ("mamba2-780m", "moonshot-v1-16b-a3b", "zamba2-7b"):
        cfg = configs.get_smoke(arch)
        master = registry.build(cfg).init(torch.Generator().manual_seed(0),
                                          "cpu", torch.float32)
        pc = TL.cast_params_for_compute(master, cfg)
        names = dict(pc.named_parameters())
        assert names.keys() == dict(master.named_parameters()).keys()
        for name, p in names.items():
            keep = p.ndim < 2 or "router" in name
            assert p.dtype == (torch.float32 if keep else torch.bfloat16), \
                name
            assert p.requires_grad
        assert not any(p.requires_grad for p in master.parameters())
    assert names["blocks.0.mixer.conv_w"].dtype == torch.bfloat16
    for k in ("A_log", "D", "dt_bias", "conv_b", "norm_w"):
        assert names[f"blocks.0.mixer.{k}"].dtype == torch.float32
    assert names["blocks.0.ln1"].dtype == torch.float32


def test_reference_casts_the_stacked_vectors():
    """The reference's fault the port departs from (ROADMAP §3): its
    ``p.ndim < 2`` test sees the layer-stacked leaves, so every per-layer
    vector but ``final_norm`` is cast to bf16, against its docstring."""
    for arch, leaves in (("mamba2-780m", ("A_log", "D", "dt_bias", "conv_b",
                                          "norm_w")),
                         ("moonshot-v1-16b-a3b", ())):
        jm = jregistry.build(jconfigs.get_smoke(arch))
        pc = JTL.cast_params_for_compute(jm.init(KEY), jnp.bfloat16)
        assert pc["blocks"]["ln1"].dtype == jnp.bfloat16
        assert pc["final_norm"].dtype == jnp.float32
        for k in leaves:
            assert pc["blocks"]["mixer"][k].dtype == jnp.bfloat16, k


def test_a_step_updates_every_master_leaf_in_place():
    """The master is updated in place, under no_grad, by the optimizer
    alone: a step moves every leaf, and nothing of the working copy's
    autograd graph is left on the state or the metrics."""
    _, cfg = _olmo("float32")
    model = registry.build(cfg)
    st = TL.init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    before = lm.params_to_numpy(st["params"], cfg)
    step = TL.make_train_step(model, TL.TrainConfig(), T_TRAIN)
    b = data_mod.SyntheticTokens(cfg.vocab, 8, 2).batch(0)
    st, m = step(st, data_mod.to_device(b, "cpu"))
    after = lm.params_to_numpy(st["params"], cfg)
    assert all(not np.array_equal(a, b_) for a, b_ in
               zip(_leaves(before), _leaves(after)))
    assert not m["loss"].requires_grad
    assert not any(p.requires_grad for p in st["params"].parameters())


# -- routing while training ---------------------------------------------------

def _spy(monkeypatch, module, name, calls):
    orig = getattr(module, name)

    def spy(*a, **kw):
        calls.append(name)
        return orig(*a, **kw)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("backend", ["auto", "kernel"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mamba2-780m",
                                  "zamba2-7b"])
def test_library_kernels_keep_the_wrappers_out(monkeypatch, arch, backend):
    """Under ``kernels="library"`` a train step never calls the flash,
    grouped or SSD wrapper (they have no backward), while the GEMMs still
    reach the IAAT plan (``auto`` routes the smoke sizes there)."""
    calls = []
    for mod, name in ((flash_attention, "flash_attention"),
                      (grouped_gemm, "batched_gemm"),
                      (grouped_gemm, "ragged_gemm"), (ssd, "ssd_scan"),
                      (iaat_gemm, "gemm_region")):
        _spy(monkeypatch, mod, name, calls)
    cfg = configs.get_smoke(arch)
    model = registry.build(cfg)
    st = TL.init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    step = TL.make_train_step(model, TL.TrainConfig(), api.Policy(
        backend=backend, kernels="library"))
    b = data_mod.SyntheticTokens(cfg.vocab, 16, 2).batch(0)
    st, m = step(st, data_mod.to_device(b, "cpu"))
    assert np.isfinite(float(m["loss"]))
    assert set(calls) == {"gemm_region"}
    # the same step with the kernel family: the wrappers are called
    calls.clear()
    with torch.no_grad():
        model.forward_train(st["params"], data_mod.to_device(b, "cpu")[
            "tokens"], api.Policy(backend=backend))
    assert set(calls) - {"gemm_region"}


def test_auto_with_library_kernels_routes_small_gemms_to_the_plan(
        monkeypatch):
    pol = api.Policy(backend="auto", kernels="library")
    assert not pol.use_kernels
    d = api.route("matmul", (4, 64, 64), "S", policy=pol)
    assert d.use_kernel and d.source == "analytical"
    calls = []
    _spy(monkeypatch, iaat_gemm, "gemm_region", calls)
    x, w = torch.randn(4, 64), torch.randn(64, 64)
    torch.testing.assert_close(api.matmul(x, w, policy=pol), x @ w,
                               rtol=1e-5, atol=1e-5)
    assert calls


def test_ref_ssd_gradient_is_finite_where_the_reference_is_not():
    """The SSD scan's library path under autograd (mamba2's train step).
    Over a full chunk the decay above the diagonal, a sum of -dt * A, can
    pass 88 and overflow exp; the reference takes exp before its mask, so
    its gradient is NaN there (at mamba2-780m's full width, chunk 128:
    every mixer's A_log and dt_bias), and the port masks first.  Forward
    against the reference's ``ref_ssd``; gradients against the token
    recurrence ``ref_ssd_recurrent``, both in f32 (1e-4 relative)."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref
    rng = np.random.RandomState(0)
    Bt, S, H, P, N, chunk = 1, 150, 2, 4, 4, 128
    x = rng.randn(Bt, S, H, P).astype(np.float32)
    dt = rng.uniform(0.5, 1.5, (Bt, S, H)).astype(np.float32)
    A = np.asarray([-2.0, -0.5], np.float32)
    B = rng.randn(Bt, S, 1, N).astype(np.float32)
    C = rng.randn(Bt, S, 1, N).astype(np.float32)
    want = np.asarray(jref.ref_ssd(*map(jnp.asarray, (x, dt, A, B, C)),
                                   chunk=chunk))
    jgrad = jax.grad(lambda d: jref.ref_ssd(
        jnp.asarray(x), d, jnp.asarray(A), jnp.asarray(B), jnp.asarray(C),
        chunk=chunk).sum())(jnp.asarray(dt))
    assert not np.isfinite(np.asarray(jgrad)).all()     # the reference's

    def grads(fn, **kw):
        ts = [torch.tensor(a, requires_grad=True) for a in (x, dt, A, B, C)]
        y = fn(*ts, **kw)
        return y, torch.autograd.grad(y.sum(), ts)
    got, g = grads(ref.ref_ssd, chunk=chunk)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    _, g_rec = grads(ref.ref_ssd_recurrent)
    for a, b in zip(g, g_rec):
        assert torch.isfinite(a).all()
        assert _rel(a.numpy(), b.numpy()) <= 1e-4


# -- weights across the two packages ------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_params_to_numpy_inverts_params_from_numpy(arch):
    jcfg = jconfigs.get_smoke(arch)
    tree = jax.tree.map(np.asarray, jregistry.build(jcfg).init(KEY))
    cfg = configs.get_smoke(arch)
    fam = _family(cfg)
    got = fam.params_to_numpy(
        fam.params_from_numpy(tree, cfg, "cpu", torch.float32), cfg)
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    for a, b in zip(_leaves(got), _leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["olmo-1b", "moonshot-v1-16b-a3b"])
def test_init_dtype_draws_the_same_weights(arch):
    """``dtype`` changes the storage, not the draws: an f32 init cast to
    the compute dtype is the default init."""
    cfg = configs.get_smoke(arch)
    m = registry.build(cfg)
    f32 = m.init(torch.Generator().manual_seed(3), "cpu", torch.float32)
    dflt = m.init(torch.Generator().manual_seed(3), "cpu")
    for (n, a), (_, b) in zip(f32.named_parameters(),
                              dflt.named_parameters()):
        assert a.dtype == (torch.float32 if b.dtype == torch.bfloat16
                           else b.dtype), n
        torch.testing.assert_close(a.to(b.dtype), b, rtol=0, atol=0)


# -- checkpoints --------------------------------------------------------------

def _trained_state(cfg, steps=1):
    model = registry.build(cfg)
    st = TL.init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    step = TL.make_train_step(model, TL.TrainConfig(opt=opt.OptConfig(**OC)),
                              T_TRAIN)
    data = data_mod.SyntheticTokens(cfg.vocab, 8, 2)
    rng = np.random.RandomState(0)
    for s in range(steps):
        b = data.batch(s)
        if cfg.family in encdec.FAMILIES:
            b["src_embeds"] = rng.randn(2, 6, cfg.d_model).astype(np.float32)
        st, _ = step(st, data_mod.to_device(b, "cpu"))
    return st


def _equal_trees(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoint_roundtrip_and_gc(tmp_path):
    cfg = configs.get_smoke("olmo-1b")
    st = _trained_state(cfg)
    cp = ck.Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        cp.save(s, TL.state_to_numpy(st, cfg), extra={"data_step": s})
    assert cp.all_steps() == [2, 3]
    tree, extra = cp.restore()
    assert extra["data_step"] == 3
    back = TL.state_from_numpy(tree, cfg, "cpu")
    assert back["step"] == st["step"] == 1
    _equal_trees(TL.state_to_numpy(back, cfg), TL.state_to_numpy(st, cfg))


def test_checkpoint_async_copies_before_training_goes_on(tmp_path):
    cp = ck.Checkpointer(str(tmp_path))
    t = torch.arange(10, dtype=torch.float32)
    cp.save(5, {"a": t, "n": {"b": np.arange(3)}}, async_=True)
    t.add_(100)                     # the next step, while it is written
    cp.wait()
    restored, _ = cp.restore({"a": 0, "n": {"b": 0}})
    np.testing.assert_array_equal(restored["a"], np.arange(10))
    np.testing.assert_array_equal(restored["n"]["b"], np.arange(3))


def test_checkpoint_atomicity(tmp_path):
    """A leftover .tmp dir is never treated as a checkpoint."""
    cp = ck.Checkpointer(str(tmp_path))
    os.makedirs(tmp_path / "step_00000009.tmp")
    cp.save(3, {"a": np.ones(3)})
    assert cp.latest_step() == 3
    with pytest.raises(ValueError, match="missing"):
        cp.restore({"b": 0})


@pytest.mark.parametrize("arch", ["olmo-1b", "moonshot-v1-16b-a3b",
                                  "zamba2-7b", "seamless-m4t-large-v2"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, arch):
    """The port writes; the JAX package's ``Checkpointer.restore``, given
    its own ``init_train_state`` shape, reads every leaf back, manifest
    for manifest the reference's layout."""
    cfg = configs.get_smoke(arch)
    st = _trained_state(cfg)
    host = TL.state_to_numpy(st, cfg)
    ck.Checkpointer(str(tmp_path)).save(1, host, extra={"data_step": 1})
    jm = jregistry.build(jconfigs.get_smoke(arch))
    like = jax.eval_shape(lambda: JTL.init_train_state(jm, KEY))
    restored, extra = jck.Checkpointer(str(tmp_path)).restore(like)
    assert extra == {"data_step": 1}
    assert jax.tree.structure(restored) == jax.tree.structure(like)
    for got, want in zip(_leaves(restored), _leaves(like)):
        assert got.shape == want.shape and got.dtype == want.dtype
    _equal_trees(jax.tree.map(np.asarray, restored), host)


def test_reference_checkpoint_trains_on_in_the_port(tmp_path):
    """The JAX trainer takes 2 steps of olmo-smoke (f32) and saves; the
    port restores it and takes step 3 with the reference's loss, grad
    norm and lr (``STEP_TOL``)."""
    jcfg, cfg = _olmo("float32")
    jm = jregistry.build(jcfg)
    jstep = jax.jit(JTL.make_train_step(
        jm, JTL.TrainConfig(opt=jopt.OptConfig(**OC)), J_TRAIN))
    data = jdata.SyntheticTokens(cfg.vocab, 32, 4, seed=0)
    jst = JTL.init_train_state(jm, KEY)
    for s in range(2):
        jst, _ = jstep(jst, {k: jnp.asarray(v)
                             for k, v in data.batch(s).items()})
    jck.Checkpointer(str(tmp_path)).save(2, jst, extra={"data_step": 2})
    tree, extra = ck.Checkpointer(str(tmp_path)).restore()
    st = TL.state_from_numpy(tree, cfg, "cpu")
    assert st["step"] == 2 and extra["data_step"] == 2
    _equal_trees(TL.state_to_numpy(st, cfg), jax.tree.map(np.asarray, jst))
    jst, jmet = jstep(jst, {k: jnp.asarray(v)
                            for k, v in data.batch(2).items()})
    tstep = TL.make_train_step(registry.build(cfg),
                               TL.TrainConfig(opt=opt.OptConfig(**OC)),
                               T_TRAIN)
    st, m = tstep(st, data_mod.to_device(data.batch(2), "cpu"))
    tl, tg, _ = STEP_TOL["float32"]
    assert _rel(float(m["loss"]), float(jmet["loss"])) <= tl
    assert _rel(float(m["grad_norm"]), float(jmet["grad_norm"])) <= tg
    assert _rel(m["lr"], float(jmet["lr"])) <= OPT_RTOL


# -- fault handling and the launcher ------------------------------------------

def test_step_monitor_flags_stragglers():
    import time
    mon = fault.StepMonitor(z_thresh=2.0, warmup=3)
    for i in range(8):
        mon.start()
        time.sleep(0.001 if i != 6 else 0.08)
        mon.stop(i)
    assert any(s.straggler for s in mon.history)
    assert mon.summary()["stragglers"] >= 1


def test_run_with_restarts_retries_and_gives_up():
    calls = []

    def train_once(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise fault.SimulatedFault("boom")
        return 42

    assert fault.run_with_restarts(train_once, max_restarts=3) == 42
    assert calls == [0, 1, 2]

    def always(attempt):
        raise OSError("disk")
    with pytest.raises(OSError):
        fault.run_with_restarts(always, max_restarts=1)


def _cli(*extra):
    return train_mod.build_args([
        "--arch", "olmo-1b", "--smoke", "--steps", "8", "--batch", "4",
        "--seq", "32", "--log-every", "100", "--device", "cpu", *extra])


def test_training_recovers_after_fault(tmp_path):
    """The launcher end to end: a fault at step 6 resumes from the step-4
    checkpoint (written asynchronously) and replays the data from there;
    the final loss is the uninterrupted run's within 1e-4 (the
    reference's bound; on the CPU the two are the same bits)."""
    obs.reset()
    out = train_mod.run(_cli("--ckpt-dir", str(tmp_path), "--ckpt-every",
                             "4", "--inject-fault-at", "6"))
    assert out["final_step"] == 8
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 3, 4, 5, 4, 5,
                                                   6, 7]
    assert obs.REGISTRY.get("train.steps").value == 10
    assert obs.REGISTRY.get("train.loss").value == out["loss"]
    assert ck.Checkpointer(str(tmp_path)).all_steps() == [4, 8]
    out2 = train_mod.run(_cli())
    assert abs(out["loss"] - out2["loss"]) < 1e-4
    c = opt.OptConfig(peak_lr=3e-4, warmup_steps=20, decay_steps=10)
    assert [h["lr"] for h in out2["history"]] == \
        [opt.schedule(s, c) for s in range(8)]
    # --resume picks the run up at its last checkpoint (step 8: no steps)
    out3 = train_mod.run(_cli("--ckpt-dir", str(tmp_path), "--resume"))
    assert out3["history"] == [] and out3["final_step"] == 8


def test_launcher_routes_by_backend_and_pins_the_kernels(monkeypatch):
    installed = []
    orig = api.install
    monkeypatch.setattr(api, "install",
                        lambda p=None, **kw: installed.append(p) or orig(p))
    train_mod.run(_cli("--steps", "1", "--backend", "auto"))
    assert installed[-1] == api.Policy(backend="auto", kernels="library")
    train_mod.run(_cli("--steps", "1"))
    assert installed[-1].backend == "library"
    assert installed[-1].kernels == "library"
    assert not installed[-1].use_kernels


def test_launcher_refusals(monkeypatch):
    """The production meshes need their 256 and 512 ranks (a world of one
    rank raises, naming them, and leaves no group up); the frontend
    families are refused as the reference refuses them.  A mesh of
    several ranks trains (``tests/test_torch_mesh.py``)."""
    import torch.distributed as dist
    with pytest.raises(ValueError, match="needs a world of 256 ranks"):
        train_mod.run(_cli("--production-mesh"))
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs a world of 512 ranks"):
        train_mod.run(_cli("--production-mesh", "--multi-pod"))
    assert not dist.is_initialized()
    for arch in ("internvl2-2b", "seamless-m4t-large-v2"):
        with pytest.raises(ValueError, match="frontend"):
            train_mod.run(train_mod.build_args(
                ["--arch", arch, "--smoke", "--device", "cpu"]))


def test_train_entry_points_default_to_the_card():
    import inspect
    for fn, arg in ((TL.init_train_state, "device"),
                    (TL.state_from_numpy, "device"),
                    (lm.init_lm, "device"), (encdec.init_encdec, "device")):
        assert inspect.signature(fn).parameters[arg].default == "cuda", fn
    assert train_mod.build_args(["--arch", "olmo-1b"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_mod.run(train_mod.build_args(["--arch", "olmo-1b",
                                                "--smoke"]))
