"""The port's train step on the families with per-layer vectors (norms,
a mamba mixer's ``A_log``, ``D``, ``dt_bias``, ``conv_b``, ``norm_w``;
the MoE router; the hybrid's shared block; the VLM's ``prefix_embeds``;
the enc-dec's ``src_embeds``) against a reference step that this test
builds from the JAX package's own ``make_loss_fn``, ``jax.value_and_grad``
and ``adamw_update``.

The reference's ``make_train_step`` tests the rank of its layer-stacked
leaves, so it casts every per-layer vector to bf16 and decays it (ROADMAP
§3).  The port follows the documented rule, which reads per-layer ranks.
So the reference step here keeps the state with each stack cut into its
layers (a list a leaf): the JAX package's ``cast_params_for_compute`` and
``adamw_update`` then see per-layer ranks, and the layers are stacked
back for the forward.  Nothing in the JAX package is edited for this.

Tolerances (``FAMILY_TOL``: loss, grad norm, the update's norm, relative;
the update's norm is ||p - p_ref|| / ||p_ref - p0|| over every leaf):
f32 1e-5, 1e-5, 3e-4 (measured at most 1.5e-7, 3.7e-7, 7.9e-5,
moonshot's experts); bf16, where each side rounds its projections in
other places and Adam turns a near-zero gradient's rounding into a full
step, 2e-3, 3e-2, 0.3 (measured at most 5.7e-4, 9.6e-3, 0.118, zamba2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.train import loop as JTL
from repro.train import optimizer as jopt
from repro_torch import api, configs
from repro_torch.models import encdec, lm, registry
from repro_torch.train import data as data_mod
from repro_torch.train import loop as TL
from repro_torch.train import optimizer as opt

KEY = jax.random.PRNGKey(0)
FAMILY_TOL = {"float32": (1e-5, 1e-5, 3e-4),
              "bfloat16": (2e-3, 3e-2, 0.3)}
OC = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
#: the JAX trees' layer stacks
STACKS = ("blocks", "enc_blocks", "dec_blocks")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _unstack(tree):
    """Each stack's leaves as lists of their layers."""
    return {k: jax.tree.map(lambda x: [x[i] for i in range(x.shape[0])], v)
            if k in STACKS else v for k, v in tree.items()}


def _stack(tree):
    return {k: jax.tree.map(jnp.stack, v,
                            is_leaf=lambda x: isinstance(x, list))
            if k in STACKS else v for k, v in tree.items()}


def _reference_step(jm, tc, be):
    """The reference's train step (``accum_steps`` 1) over a state whose
    stacks are cut into layers: the documented per-layer cast and decay."""
    vg = jax.value_and_grad(JTL.make_loss_fn(jm, tc, be), has_aux=True)

    def step(st, batch):
        pc = _stack(JTL.cast_params_for_compute(st["params"],
                                                jm.cfg.compute_dtype))
        (loss, _), g = vg(pc, batch)
        p, o, om = jopt.adamw_update(st["params"], _unstack(g), st["opt"],
                                     st["step"], tc.opt)
        return {"params": p, "opt": o, "step": st["step"] + 1}, \
            {"loss": loss, **om}
    return step


def _batch(rng, cfg):
    b = {"tokens": rng.randint(0, cfg.vocab, (2, 16)).astype(np.int32)}
    if cfg.frontend == "vision":
        b["prefix_embeds"] = rng.randn(2, cfg.frontend_tokens,
                                       cfg.d_model).astype(np.float32)
    if cfg.family in encdec.FAMILIES:
        b["src_embeds"] = rng.randn(2, 12, cfg.d_model).astype(np.float32)
    return b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b",
                                  "moonshot-v1-16b-a3b", "internvl2-2b",
                                  "seamless-m4t-large-v2"])
def test_train_step_matches_the_per_layer_reference(arch, dtype):
    """Two steps of B 2 x S 16 from the same parameters under ``auto``
    with the non-GEMM kernels on the library."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype)
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=dtype)
    jm = jregistry.build(jcfg)
    jp = jm.init(KEY)
    start = jax.tree.map(np.asarray, jp)
    ju = _unstack(jp)
    jst = {"params": ju, "opt": jopt.init_opt_state(ju),
           "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(_reference_step(
        jm, JTL.TrainConfig(opt=jopt.OptConfig(**OC)),
        japi.named_policy("auto").replace(kernels="xla")))
    fam = encdec if cfg.family in encdec.FAMILIES else lm
    p = fam.params_from_numpy(start, cfg, "cpu", torch.float32)
    st = {"params": p, "opt": opt.init_opt_state(p), "step": 0}
    tstep = TL.make_train_step(registry.build(cfg),
                               TL.TrainConfig(opt=opt.OptConfig(**OC)),
                               api.Policy(backend="auto", kernels="library"))
    tl, tg, tu = FAMILY_TOL[dtype]
    rng = np.random.RandomState(0)
    for _ in range(2):
        b = _batch(rng, cfg)
        jst, jmet = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        st, m = tstep(st, data_mod.to_device(b, "cpu"))
        assert _rel(float(m["loss"]), float(jmet["loss"])) <= tl
        assert _rel(float(m["grad_norm"]), float(jmet["grad_norm"])) <= tg
        assert m["lr"] == pytest.approx(float(jmet["lr"]), rel=1e-6)
    got = jax.tree.leaves(fam.params_to_numpy(st["params"], cfg))
    want = jax.tree.leaves(jax.tree.map(np.asarray, _stack(jst["params"])))
    num = sum(float(((g.astype(np.float64) - w) ** 2).sum())
              for g, w in zip(got, want))
    den = sum(float(((w.astype(np.float64) - s) ** 2).sum())
              for w, s in zip(want, jax.tree.leaves(start)))
    assert (num / den) ** 0.5 <= tu
