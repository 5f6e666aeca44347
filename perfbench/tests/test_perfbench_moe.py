"""The sparse-expert family (``families/moe.py``) and its plain reference
(``reference/moe.py``): the counts at mixtral-8x22b's full widths held
to hand arithmetic; the seeded draw (f32 router and gains after the
bf16 matrices); the reference against the port at a small size (prefill
then decode through the cache, every served call on the dropless row
tiles); the routing-stable statistic, which separates the fp8 control
and the harness's faults from a sound run; and the three new readers on
a CPU traced run of the cell."""
import json
import pathlib

import numpy as np
import pytest
import torch

from perfbench import faults, program, serve, spec, weights
from perfbench.reference import moe as ref
from perfbench.work import counts
from conftest import small_chat

BENCH = pathlib.Path(__file__).resolve().parents[1]
CELL = "mixtral-8x22b.chat-32"
SEED = 2 ** 31 + 2024


def doc():
    return json.loads((BENCH / "configs" / "mixtral-8x22b.json").read_text())


def small(**kw):
    """mixtral-8x22b's file at a test size: every width cut, 8 experts of
    top-2 and the structure kept."""
    d = doc()
    d.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             vocab=256, vocab_rows=256,
             moe=dict(d["moe"], d_expert=128))
    d.update(kw)
    return d


def wider(**kw):
    """A size at which bf16's rounding reads as far below the fp8
    control's gaps as at the cell's widths: 4 layers of d 512."""
    return small(**dict(dict(n_layers=4, d_model=512, head_dim=128,
                             vocab=2048, vocab_rows=2048,
                             moe=dict(doc()["moe"], d_expert=1024)), **kw))


# -- counts at full widths ------------------------------------------------------

def test_bytes_a_layer_and_a_stage():
    """5.008 GB of weights a layer (experts 4.832, attention 0.176, the f32
    router and gains 0.25 MB), 40.87 GB with the embedding and head."""
    d = doc()
    fam = spec.family("moe")
    bf16 = sum(int(np.prod(s)) for _, s, _ in fam.layer_shapes(d)) * 2
    f32 = sum(int(np.prod(s)) for _, s, _ in fam.f32_shapes(d)) * 4
    experts = 3 * 8 * 6144 * 16384 * 2
    attn = (2 * 6144 * 6144 + 2 * 6144 * 1024) * 2
    assert bf16 == experts + attn
    assert experts == pytest.approx(4.832e9, rel=1e-3)
    assert attn == pytest.approx(0.176e9, rel=2e-3)
    assert f32 == (6144 * 8 + 2 * 6144) * 4
    assert bf16 + f32 == pytest.approx(5.008e9, rel=1e-3)
    outer = sum(int(np.prod(s)) for _, s, _ in fam.outer_shapes(d)) * 2
    assert outer == 2 * 32768 * 6144 * 2
    assert 8 * (bf16 + f32) + outer + 6144 * 4 == \
        pytest.approx(40.87e9, rel=1e-3)


def test_pass_params_and_expert_work():
    d = doc()
    g = counts.pass_gemms(d, 32)
    per = [(6144, 6144), (6144, 1024), (6144, 1024), (6144, 6144), (6144, 8)]
    assert g == [(32, K, N) for _ in range(8) for K, N in per] + \
        [(32, 6144, 32768)]
    attn = 2 * 6144 * 6144 + 2 * 6144 * 1024 + 6144 * 8
    two = 2 * 3 * 6144 * 16384
    assert counts.matmul_params(d) == 8 * (attn + two) + 6144 * 32768
    # one decode call of one layer: 64 pairs over all 8 experts
    fam = spec.family("moe")
    flops, nbytes = fam.expert_work(d, 64, 8, counts.elt(d))
    assert flops == 2 * 64 * 3 * 6144 * 16384
    # each row: x into gate and up, their outputs, h into down, its output
    assert nbytes == (8 * 3 * 6144 * 16384 + 64 * 3 * (6144 + 16384)) * 2
    # bytes-bound: 4.840 GB at 3.35 TB/s, 1.445 ms
    assert counts.bound_s(flops, nbytes) == pytest.approx(1.4449e-3,
                                                          rel=1e-4)
    steps = fam.train_step_gemms(d, 1, 64)
    assert len(steps) == 8 * (5 + 24) * 4 + 3
    assert (16, 6144, 16384) in steps


def test_draw_order_and_gains():
    """The f32 router and gains come after the bf16 matrices from the same
    generator; the gains spread about 1; the port's tree holds the draw."""
    d = small()
    w = weights.layer(d, SEED, 1, torch.bfloat16, "cpu")
    assert w["moe.w_gate"].dtype == torch.bfloat16
    assert w["moe.router"].dtype == torch.float32
    assert w["moe.w_gate"].shape == (8, 64, 128)
    assert w["moe.w_down"].shape == (8, 128, 64)
    for n in ("ln1", "ln2"):
        assert abs(float(w[n].mean()) - 1.0) < 0.05
        assert 0.05 < float(w[n].std()) < 0.15
    again = weights.layer(d, SEED, 1, torch.bfloat16, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    params = program.port_params(d, SEED, torch.bfloat16, "cpu")
    named = dict(params.named_parameters())
    assert torch.equal(named["blocks.1.moe.router"], w["moe.router"])
    assert torch.equal(named["blocks.1.ln2"], w["ln2"])
    assert named["final_norm"].dtype == torch.float32
    cfg = program.port_config(d)
    assert cfg.moe.dropless and cfg.family == "moe" and cfg.d_ff == 128


# -- the reference against the port --------------------------------------------

def test_prefill_then_decode_matches_the_reference():
    """f32, small size: the port's wave prefill (capacity at C = T) then
    five decode steps (the dropless row tiles) against the reference's
    one forward over the whole sequences."""
    d = small(dtype="float32")
    from repro_torch import api, obs
    from repro_torch.models import registry
    cfg = program.port_config(d)
    model = registry.build(cfg)
    params = program.port_params(d, SEED, torch.float32, "cpu")
    be = api.named_policy("auto")
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, d["vocab"], (2, 11)))
    steps = 5
    with torch.no_grad(), obs.capture():
        obs.reset()
        lg, cache = model.prefill(params, prompt, be, cache_len=11 + steps)
        got, toks = [lg], [prompt]
        for _ in range(steps):
            nxt = got[-1].argmax(-1)[:, None]
            toks.append(nxt)
            lg, cache = model.decode(params, nxt, cache, be)
            got.append(lg)
        tiled = sum(r.name == "model.moe.dispatch" for r in obs.spans())
    assert tiled == steps * d["n_layers"]
    full = torch.cat(toks, 1)
    want = ref.logits(d, SEED, list(full), "cpu")["f32"]
    for b in range(2):
        have = torch.stack([g[b] for g in got])
        w = want[b][10:10 + steps + 1]
        assert float((have - w).abs().max() / w.abs().max()) < 1e-5


def test_margins_are_the_smallest_over_layers(monkeypatch):
    """Each position's margin is its smallest over the layers of the
    second-to-third router logit gap, read in the f32 pass."""
    d = small(dtype="float32")
    seq = torch.as_tensor(np.random.default_rng(1).integers(0, 256, 9))
    seen, experts = [], ref.experts

    def spy(x, w, doc, num):
        y, margin = experts(x, w, doc, num)
        logits = torch.sort(x @ w["moe.router"], descending=True).values
        assert torch.allclose(margin, logits[:, 1] - logits[:, 2])
        seen.append(margin)
        return y, margin
    monkeypatch.setattr(ref, "experts", spy)
    _, margins = ref.forward(d, SEED, [seq], "cpu")
    assert len(seen) == d["n_layers"]
    assert torch.equal(margins[0], torch.minimum(*seen))
    assert bool((margins[0] >= 0).all())


# -- the check ------------------------------------------------------------------

def _serve(**kw):
    return serve.run(wider(), small_chat(), spec.limits(CELL), SEED, 6.0,
                     False, device="cpu", **kw)


def test_sound_run_is_correct():
    res = _serve()
    assert res["correct"], res["checks"]
    assert res["gaps"]["excluded_share"] < 1.0


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_fault_is_not_correct(fault, monkeypatch):
    faults.SERVE[fault](monkeypatch.setattr)
    res = _serve()
    assert not res["correct"], res["checks"]


def test_control_is_not_correct():
    """The fp8 reference's tokens judged in the program's place."""
    res = _serve(control=True)
    assert not res["correct"], res["checks"]
    lim = spec.limits(CELL)
    assert dict((k, v) for k, v, _ in res["checks"]) == dict(
        {k: res["gaps"]["control_" + k] for k in lim}, failed=0.0)


# -- the readers ----------------------------------------------------------------

def test_a_traced_cpu_run_reads_the_moe_metrics():
    """A traced CPU run of the cell at a small size: the dispatch spans and
    the tally read numbers; the ragged kernel has no device trace here."""
    from repro_torch import obs
    obs.reset()
    d = small(dtype="float32")
    res = serve.run(d, small_chat(), spec.limits(CELL), SEED, 2.0, True,
                    device="cpu")
    ctx = res["ctx"]
    t = obs.tallies()["moe"]
    assert t["calls"] and t["pairs"] and t["tile_rows"] >= t["pairs"]
    assert t["experts_touched"] <= 8 * t["calls"]
    assert spec.reader("expert_row_use.serve")(ctx) == pytest.approx(
        100.0 * t["pairs"] / t["tile_rows"])
    assert spec.reader("moe_dispatch_ms.serve")(ctx) > 0
    assert spec.reader("expert_roofline.serve")(ctx) is None
    bench = spec.load_benchmark()
    names = {m["name"] for m in spec.metrics_of(bench, "per_layer", CELL)}
    assert {"moe_dispatch_ms.serve", "expert_row_use.serve",
            "expert_roofline.serve", "mfu.serve",
            "paged_attn_kernel_share.serve"} <= names


def test_the_roofline_reads_the_ragged_launches():
    """Three ``grouped_gemm_kernel`` launches a tallied call: the work over
    their time; any other number of them (a batched launch among them):
    nothing."""
    from repro_torch import obs
    d = doc()
    obs.reset()
    obs.tally("moe", ("pairs", "live_tiles", "tile_rows", "second_tiles",
                      "experts_touched"), torch.tensor([64, 8, 128, 0, 8]))
    kern = [{"name": "void grouped_gemm_kernel<bf16, 16, 256, 64, 1>",
             "ts": 0.0, "dur": 500.0, "cat": "kernel", "op": None,
             "dims": None}] * 3
    ctx = {"kind": "serve", "doc": d, "slice": {"kernels": kern}}
    read = spec.reader("expert_roofline.serve")
    assert read(ctx) == pytest.approx(100.0 * 1.4449e-3 / 1.5e-3, rel=1e-4)
    ctx["slice"]["kernels"] = kern + kern[:1]
    assert read(ctx) is None
    obs.reset()
    assert read(ctx) is None
