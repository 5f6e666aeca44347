"""``cfg.remat`` in the port's training: each layer of ``forward_train``
(and of the enc-dec's encoder and decoder) is checkpointed as the
reference wraps each scanned layer in ``jax.checkpoint``.

Every family's smoke config in f32 on the CPU: the gradients under
``full``, ``dots`` and ``none`` are equal to the bit (the recompute runs
the same ops on the same inputs), ``full`` keeps fewer bytes for the
backward pass (counted by ``torch.autograd.graph.saved_tensors_hooks``,
which sees what autograd saves outside the checkpointed layers), nothing
is checkpointed where autograd records nothing, and the route log, which
counts executions, counts the recompute of every routed GEMM of the
blocks.  The train step's parity with the reference's
``make_train_step`` (whose configs remat ``full`` as well) is
``tests/test_torch_train.py``'s.
"""
import dataclasses

import pytest
import torch

from repro_torch import api, configs, obs
from repro_torch.models import registry
from repro_torch.train import loop as TL

FAMILIES = ["olmo-1b", "moonshot-v1-16b-a3b", "mamba2-780m", "zamba2-7b",
            "seamless-m4t-large-v2"]
LIBRARY = api.named_policy("library")
#: GEMMs routed to the IAAT kernel (its plain version inside its autograd
#: Function, on the CPU); the kernels without a backward on the library
KERNEL = api.Policy(backend="kernel", kernels="library")


def _setup(arch, remat):
    cfg = dataclasses.replace(configs.get_smoke(arch), remat=remat,
                              dtype="float32")
    model = registry.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu",
                        torch.float32)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g)}
    if cfg.frontend == "audio":
        batch["src_embeds"] = torch.randn(2, 12, cfg.d_model, generator=g)
    return cfg, model, params, batch


def _grads(arch, remat, policy=LIBRARY):
    """(loss, gradients by name, bytes autograd saved outside the
    checkpointed layers) of one loss on the smoke config."""
    cfg, model, params, batch = _setup(arch, remat)
    pc = TL.cast_params_for_compute(params, cfg)
    loss_fn = TL.make_loss_fn(model, TL.TrainConfig(), policy)
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = loss_fn(pc, batch)
    names, leaves = zip(*pc.named_parameters())
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), dict(zip(names, gs)), saved[0]


@pytest.mark.parametrize("arch,policy", [(a, "library") for a in FAMILIES]
                         + [("olmo-1b", "kernel"),
                            ("moonshot-v1-16b-a3b", "kernel")])
def test_gradients_equal_under_every_remat(arch, policy):
    """The library policy for every family; the IAAT kernel's autograd
    Function (forward twice a layer under ``full``) for a dense and an
    MoE config."""
    pol = LIBRARY if policy == "library" else KERNEL
    loss, want, _ = _grads(arch, "none", pol)
    for remat in ("full", "dots"):
        got_loss, got, _ = _grads(arch, remat, pol)
        assert torch.equal(got_loss, loss), remat
        assert set(got) == set(want)
        for n, g in want.items():
            assert (g is None) == (got[n] is None), n
            if g is not None:
                assert torch.equal(got[n], g), (remat, n)


@pytest.mark.parametrize("arch", FAMILIES)
def test_full_saves_less_than_none(arch):
    *_, none = _grads(arch, "none")
    *_, full = _grads(arch, "full")
    assert 0 < full < none / 3, (full, none)


def test_no_checkpoint_where_autograd_records_nothing(monkeypatch):
    """Under ``torch.no_grad`` (the scoring phases) ``forward_train`` runs
    each layer plainly; with autograd on, once a layer."""
    import torch.utils.checkpoint as ckpt
    calls = []
    real = ckpt.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)
    monkeypatch.setattr(ckpt, "checkpoint", spy)
    for arch in ("olmo-1b", "seamless-m4t-large-v2"):
        cfg, model, params, batch = _setup(arch, "full")
        extra = [batch["src_embeds"]] if "src_embeds" in batch else []
        with torch.no_grad():
            model.forward_train(params, batch["tokens"], LIBRARY, *extra)
        assert calls == []
        pc = TL.cast_params_for_compute(params, cfg)
        model.forward_train(pc, batch["tokens"], LIBRARY, *extra)
        assert len(calls) == cfg.n_layers + cfg.n_encoder_layers
        assert all(not kw["use_reentrant"] for kw in calls)
        calls.clear()


@pytest.mark.parametrize("arch", ["olmo-1b", "zamba2-7b"])
def test_route_log_counts_the_recompute(arch):
    """The route log counts executions: under ``full`` a loss and its
    gradients route each block GEMM once more than under ``none`` (the
    recompute), the vocabulary head not again; the hybrid's shared
    block's GEMMs are routed again with the layer they precede.  The
    recompute stops once the backward has every tensor it saved, which
    for a block's last GEMM is after its route and its forward (the
    kernel's autograd Function saves its inputs last)."""
    counts = {}
    for remat in ("none", "full"):
        obs.ROUTES.reset()
        _grads(arch, remat, KERNEL)
        counts[remat] = obs.ROUTES.total
    cfg, model, params, batch = _setup(arch, "none")
    obs.ROUTES.reset()
    with torch.no_grad():
        model.forward_train(params, batch["tokens"], KERNEL)
    forward = obs.ROUTES.total
    obs.ROUTES.reset()
    with torch.no_grad():
        from repro_torch.models import lm
        x = lm._embed_tokens(params, cfg, batch["tokens"])
        lm._unembed(params, cfg, x, KERNEL)
    head = obs.ROUTES.total
    obs.ROUTES.reset()
    assert head == 1
    assert counts["full"] - counts["none"] == forward - head > 0


def test_train_step_is_the_same_under_remat():
    """One olmo-smoke train step from one state under ``full`` and
    ``none``: the same loss, gradient norm and new state to the bit."""
    out = {}
    for remat in ("none", "full"):
        cfg, model, _params, batch = _setup("olmo-1b", remat)
        st = TL.init_train_state(model, torch.Generator().manual_seed(0),
                                 "cpu")
        st, m = TL.make_train_step(model, TL.TrainConfig(), LIBRARY)(st,
                                                                    batch)
        out[remat] = (st, m)
    (a, ma), (b, mb) = out["none"], out["full"]
    assert torch.equal(ma["loss"], mb["loss"])
    assert torch.equal(ma["grad_norm"], mb["grad_norm"])
    for part in ("params",):
        for (n, x), (_, y) in zip(a[part].named_parameters(),
                                  b[part].named_parameters()):
            assert torch.equal(x, y), n
    for k in ("m", "v"):
        for (n, x), (_, y) in zip(a["opt"][k].named_parameters(),
                                  b["opt"][k].named_parameters()):
            assert torch.equal(x, y), (k, n)
