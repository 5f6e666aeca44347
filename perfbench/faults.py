"""Faults planted in the timed path, for the checks that ``correct``
must fail (``tests/test_perfbench_control.py`` on the CPU, and
``calibrate.py --fault`` on the card, at the cell's own size).  Each
takes ``patch(owner, name, value)``, a ``setattr`` or pytest's
``monkeypatch.setattr``.  None runs in a benchmark run."""
import dataclasses

import torch


def serve_state_unchanged(patch):
    """Every model call works on a copy of the KV pools: the step leaves
    the engine's state as it found it."""
    from repro_torch.models import lm
    core = lm._paged_core

    def broken(params, cfg, be, x, ps, *a, **k):
        copy = dataclasses.replace(
            ps, attn_k=ps.attn_k.clone(), attn_v=ps.attn_v.clone())
        return core(params, cfg, be, x, copy, *a, **k)
    patch(lm, "_paged_core", broken)


def serve_token_altered(patch):
    """Every fourth sampling call hands out the next id after the one it
    picked, where the engine produces its tokens."""
    from repro_torch.serve import engine
    sample, n = engine.sample, [0]

    def broken(logits, generator, temperature=0.0):
        out = sample(logits, generator, temperature)
        n[0] += 1
        return (out + 1) % logits.shape[-1] if n[0] % 4 == 0 else out
    patch(engine, "sample", broken)


def train_state_unchanged(patch):
    """AdamW returns the state as it found it."""
    from repro_torch.train import optimizer
    patch(optimizer, "adamw_update",
          lambda p, g, o, step, c: (p, o, {"grad_norm": torch.zeros(()),
                                           "lr": 0.0}))


def train_half_batch(patch):
    """The step takes the first half of the batch's rows; the loss is the
    mean over the rest."""
    from repro_torch.train import loop
    make = loop.make_train_step

    def broken(model, tc, be):
        step = make(model, tc, be)
        return lambda state, batch: step(state, {
            "tokens": batch["tokens"][:batch["tokens"].shape[0] // 2]})
    patch(loop, "make_train_step", broken)


def train_update_doubled(patch):
    """One leaf's update applied twice where AdamW produces it."""
    from repro_torch.train import optimizer
    upd = optimizer.adamw_update

    def broken(params, grads, opt_state, step, c):
        leaf = dict(params.named_parameters())["blocks.0.attn.wq"]
        before = leaf.detach().clone()
        out = upd(params, grads, opt_state, step, c)
        with torch.no_grad():
            leaf.add_(leaf - before)
        return out
    patch(optimizer, "adamw_update", broken)


SERVE = {"state_unchanged": serve_state_unchanged,
         "token_altered": serve_token_altered}
TRAIN = {"state_unchanged": train_state_unchanged,
         "half_batch": train_half_batch,
         "update_doubled": train_update_doubled}
