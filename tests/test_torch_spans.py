"""The port's span recorder (``repro_torch.obs.span``): nothing recorded
and no profiler range opened outside a capture; records with parents,
request ids and attributes inside ``obs.capture()`` and inside a
``torch.profiler`` run; drops counted past the cap; and the spans the
paged engine and the train step open, nested as the layers are."""
import collections

import numpy as np
import pytest
import torch

from repro_torch import api, configs, obs
from repro_torch.launch.serve import random_requests
from repro_torch.models import registry
from repro_torch.serve import PagedEngine
from repro_torch.train import loop, optimizer

AUTO = api.Policy(backend="auto")


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.set_enabled(True)
    obs.reset()
    yield
    obs.set_enabled(True)
    obs.reset()


@pytest.fixture
def no_profiler_range(monkeypatch):
    """Counts every ``record_function`` a span opens."""
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return opened


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_outside_a_capture_a_span_records_nothing(monkeypatch,
                                                  no_profiler_range):
    """No record, no profiler range, no clock read: the span is the one
    shared no-op object, and a routed GEMM leaves no dispatch record."""
    def no_clock():
        raise AssertionError("a clock was read outside a capture")
    monkeypatch.setattr(obs.time, "perf_counter_ns", no_clock)
    assert not obs.capturing()
    a, b = obs.span("outer"), obs.span("inner", rid=3, device=True, k=1)
    assert a is b and not a
    with a:
        with b:
            api.matmul(torch.ones(4, 8), torch.ones(8, 8), policy=AUTO)
    assert obs.spans() == [] and obs.span_drops() == 0
    assert no_profiler_range == []


def test_capture_nests_spans_with_parents_rids_and_attrs(no_profiler_range):
    with obs.capture():
        assert obs.capturing()
        with obs.span("outer", rid=7, which="decode") as sp:
            assert sp and sp.t0_ns > 0
            sp.set(waited_us=12.5)
            with obs.span("inner"):
                pass
            with obs.span("second"):
                with obs.span("leaf", layer=3):
                    pass
    assert not obs.capturing()
    recs = obs.spans()
    assert [r.name for r in recs] == ["outer", "inner", "second", "leaf"]
    assert [r.parent for r in recs] == [-1, 0, 0, 2]
    assert recs[0].rid == 7 and recs[1].rid is None
    assert recs[0].attrs == {"which": "decode", "waited_us": 12.5}
    assert recs[3].attrs == {"layer": 3} and recs[1].attrs is None
    for r in recs:
        assert r.t1_ns is not None and r.t0_ns <= r.t1_ns
        assert r.device_ms is None          # on the CPU
    assert recs[0].t0_ns <= recs[1].t0_ns and recs[3].t1_ns <= recs[0].t1_ns
    # a capture with no profiler running opens no profiler range
    assert no_profiler_range == []


def test_profiler_run_is_a_capture_and_opens_same_named_ranges(
        no_profiler_range):
    with _cpu_profile() as prof:
        assert obs.capturing()
        with obs.span("serve.step"):
            with obs.span("model.call", which="decode"):
                with obs.span("model.mlp", ranged=False, layer=0):
                    torch.ones(3).sum()
    assert not obs.capturing()
    recs = obs.spans()
    assert [r.name for r in recs] == ["serve.step", "model.call",
                                      "model.mlp"]
    assert [r.parent for r in recs] == [-1, 0, 1]
    # the unranged span is recorded but opens no profiler range
    assert no_profiler_range == ["serve.step", "model.call"]
    names = {e.key for e in prof.key_averages()}
    assert {"serve.step", "model.call"} <= names
    assert "model.mlp" not in names


def test_buffer_counts_drops_past_its_cap(monkeypatch):
    monkeypatch.setattr(obs._Recorder, "CAP", 3)
    with obs.capture():
        with obs.span("a"):
            with obs.span("b"):
                obs.mark("m", obs.time.perf_counter_ns())
            with obs.span("c"):          # dropped
                with obs.span("d"):      # dropped: its parent is unknown
                    pass
    recs = obs.spans()
    assert [r.name for r in recs] == ["a", "b", "m"]
    assert recs[2].parent == 1                     # the mark's open span
    assert obs.span_drops() == 2
    obs.reset()
    assert obs.spans() == [] and obs.span_drops() == 0


def test_routed_gemm_is_one_cheap_dispatch_record(no_profiler_range):
    x, w = torch.randn(4, 16), torch.randn(16, 8)
    with _cpu_profile():
        with obs.span("model.mlp", layer=0):
            api.matmul(x, w, policy=AUTO)
            api.gemm(x, w, policy=api.Policy(backend="library"))
    recs = obs.spans()
    assert [r.name for r in recs] == ["model.mlp", "gemm.dispatch",
                                      "gemm.dispatch"]
    assert [r.parent for r in recs] == [-1, 0, 0]
    assert recs[1].t0_ns < recs[1].t1_ns <= recs[2].t0_ns
    # no profiler range a dispatch: only the span's own
    assert no_profiler_range == ["model.mlp"]


def test_reset_and_the_kill_switch():
    obs.set_enabled(False)
    with obs.capture():
        assert not obs.capturing()
        with obs.span("x"):
            pass
    assert obs.spans() == []
    obs.set_enabled(True)
    with obs.capture(), obs.span("x"):
        pass
    assert len(obs.spans()) == 1
    obs.reset()
    assert obs.spans() == []


def _engine(cfg):
    model = registry.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    eng = PagedEngine(model, params, AUTO, slots=2, max_len=96, chunk=8,
                      device="cpu")
    for r in random_requests(cfg, 4, 5, seed=1):
        eng.submit(r)
    return eng


def _chain(recs, i):
    names = []
    while i >= 0:
        names.append(recs[i].name)
        i = recs[i].parent
    return names


def test_paged_engine_spans_nest_as_the_layers():
    """A CPU PagedEngine run under a CPU profiler: serve.step > serve.decode
    > model.call > model.attention / model.mlp > gemm.dispatch, attention
    over the pool (model.attention > model.paged_attend, the plain path on
    the CPU), the prefill chunk's model call, the syncs, and a
    ``waited_us`` on each request's first chunk, once."""
    cfg = configs.get_smoke("olmo-1b")
    eng = _engine(cfg)
    with _cpu_profile():
        out = eng.run()
    recs = obs.spans()
    assert obs.span_drops() == 0
    names = collections.Counter(r.name for r in recs)
    for n in ("serve.step", "serve.decode", "serve.prefill", "serve.drain",
              "serve.sync", "model.call", "model.attention", "model.mlp",
              "model.head", "gemm.dispatch"):
        assert names[n] > 0, n
    chains = {tuple(_chain(recs, i)) for i in range(len(recs))}
    assert ("gemm.dispatch", "model.attention", "model.call", "serve.decode",
            "serve.step") in chains
    assert ("gemm.dispatch", "model.mlp", "model.call", "serve.prefill",
            "serve.step") in chains
    assert ("gemm.dispatch", "model.head", "model.call", "serve.decode",
            "serve.step") in chains
    assert ("serve.sync", "serve.drain", "serve.step") in chains
    # the plain paged attention's blocking copy, inside its span
    assert ("serve.sync", "model.paged_attend", "model.attention",
            "model.call", "serve.decode", "serve.step") in chains
    assert ("serve.sync", "serve.prefill", "serve.step") in chains
    for r in recs:
        if r.name == "model.call":
            assert r.attrs["which"] in ("decode", "prefill")
            assert recs[r.parent].name == "serve." + r.attrs["which"]
        if r.name in ("model.attention", "model.mlp"):
            assert 0 <= r.attrs["layer"] < cfg.n_layers
        if r.name == "model.paged_attend":
            assert r.attrs == {"path": "plain"}          # the CPU
            assert recs[r.parent].name == "model.attention"
    assert names["model.paged_attend"] == names["model.attention"]
    per_call = names["model.attention"] / names["model.call"]
    assert per_call == cfg.n_layers
    # one serve.step a step() call, every span closed, in its parent
    for r in recs:
        assert r.t1_ns is not None
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.t0_ns <= r.t0_ns and r.t1_ns <= p.t1_ns
    waits = [(r.rid, r.attrs["waited_us"]) for r in recs
             if r.name == "serve.prefill" and r.attrs]
    assert sorted(rid for rid, _ in waits) == sorted(out)
    assert all(w >= 0 for _, w in waits)
    assert all(r.rid is not None for r in recs if r.name == "serve.prefill")


def test_spans_leave_the_served_tokens_unchanged():
    cfg = configs.get_smoke("olmo-1b")
    plain = _engine(cfg).run()
    with obs.capture():
        captured = _engine(cfg).run()
    assert captured == plain and obs.spans()


def test_train_step_spans():
    """A train step under a capture: train.step holds the gradients (with
    the forward's block spans under them) and AdamW; no device time on
    the CPU."""
    cfg = configs.get_smoke("olmo-1b")
    model = registry.build(cfg)
    state = loop.init_train_state(model, torch.Generator().manual_seed(0),
                                  "cpu")
    step = loop.make_train_step(model, loop.TrainConfig(
        opt=optimizer.OptConfig()), api.Policy(backend="auto",
                                               kernels="library"))
    tokens = torch.from_numpy(
        np.random.RandomState(0).randint(0, cfg.vocab, (2, 16)))
    with obs.capture():
        step(state, {"tokens": tokens})
    recs = obs.spans()
    top = [r.name for r in recs if r.parent == -1 and r.name.startswith(
        "train.")]
    assert top == ["train.step"]
    kids = [r.name for r in recs if r.parent == 0]
    assert kids == ["train.grads", "train.optimizer"]
    fwd = [r for r in recs if r.name == "model.attention"
           and _chain(recs, recs.index(r))[-1] == "train.step"]
    assert len(fwd) >= cfg.n_layers
    assert all(r.device_ms is None for r in recs)
