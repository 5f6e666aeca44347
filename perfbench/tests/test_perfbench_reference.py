"""The plain references held against the port's own plain path (on the
CPU every kernel wrapper runs its plain version) at the
configuration's smoke size, in f32: prefill then decode through the
cache against one full forward, and train steps."""
import numpy as np
import pytest
import torch

from perfbench import gen, program
from perfbench import train as train_cell
from perfbench.reference import dense
from conftest import small_train, smoke

@pytest.mark.parametrize("window", [None, 8])
def test_prefill_then_decode_matches_one_forward(window):
    doc = smoke("olmo-1b", dtype="float32",
                attn={"kind": "full" if window is None else "swa",
                      "window": window})
    from repro_torch import api
    from repro_torch.models import registry
    cfg = program.port_config(doc)
    model = registry.build(cfg)
    seed = 2 ** 31 + 99
    params = program.port_params(doc, seed, torch.float32, "cpu")
    be = api.named_policy("auto")
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, doc["vocab"], (2, 11)))
    steps = 5
    with torch.no_grad():
        lg, cache = model.prefill(params, prompt, be, cache_len=11 + steps)
        got, toks = [lg], [prompt]
        for _ in range(steps):
            nxt = got[-1].argmax(-1)[:, None]
            toks.append(nxt)
            lg, cache = model.decode(params, nxt, cache, be)
            got.append(lg)
    full = torch.cat(toks, 1)
    ref = dense.logits(doc, seed, list(full), "cpu")["f32"]
    for b in range(2):
        want = ref[b][10:10 + steps + 1]
        have = torch.stack([g[b] for g in got])
        scale = want.abs().max()
        assert float((have - want).abs().max() / scale) < 1e-5


def test_train_steps_match_the_reference():
    doc = smoke("olmo-1b", dtype="float32")
    mix = small_train()
    from repro_torch import api
    from repro_torch.models import registry
    from repro_torch.train import loop, optimizer
    cfg = program.port_config(doc)
    model = registry.build(cfg)
    seed = 12345
    params = program.port_params(doc, seed, torch.float32, "cpu")
    state = {"params": params, "opt": optimizer.init_opt_state(params),
             "step": 0}
    oc = optimizer.OptConfig(**mix["optimizer"])
    step = loop.make_train_step(model, loop.TrainConfig(
        opt=oc, z_loss=mix["z_loss"]),
        api.named_policy("auto").replace(kernels="library"))
    batches = [gen.train_batch(mix, seed, j, doc["vocab"], "cpu")
               for j in range(3)]
    p0 = {k: v.detach().clone() for k, v in params.named_parameters()}
    prog = {"loss": []}
    for j, b in enumerate(batches):
        state, met = step(state, {"tokens": b})
        prog["loss"].append(float(met["loss"]))
        if j == 0:
            prog["grad1"] = {k: float(m.norm()) / (1 - oc.b1) for k, m in
                             state["opt"]["m"].named_parameters()}
    prog["change"] = {k: float((v - p0[k]).norm())
                      for k, v in state["params"].named_parameters()}
    ref = dense.train_steps(doc, seed, batches, mix["optimizer"],
                            mix["z_loss"], "cpu")
    assert set(ref["grad1"]) == set(prog["grad1"])
    gaps = train_cell.compare(prog, ref)
    assert gaps["loss_gap"] < 1e-6
    assert gaps["grad_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-3
