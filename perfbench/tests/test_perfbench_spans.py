"""The program's spans on the traced slice's clock (``hostspans``) and the
seven readers built on them: a known offset recovered from synthetic
harness and program spans, a misaligned slice refused, each reader's
number on a synthetic slice and None where it has nothing to read, and
a CPU traced run of the serving and training cells."""
import pytest

from perfbench import hostspans, serve, spec, train
from repro_torch import obs
from conftest import small_chat, small_train, smoke

OFF = 5_000.0          # program us + OFF = the slice's us
SERVE_READERS = ("engine_host_ms.serve", "model_host_ms.serve",
                 "gemm_dispatch_us.serve", "sync_wait_ms.serve",
                 "dispatch_idle_ms.serve", "prefill_wait_ms.serve")


def _rec(name, a, b, parent=-1, rid=None, attrs=None, dev=None):
    return obs.SpanRecord(name, int(a * 1e3), int(b * 1e3), parent, rid,
                          attrs, dev)


def _serve_step(recs, k, waited=None):
    """One engine step at program time 1000 k us: 800 us long, with a
    decode call (an attention half holding a sync and a dispatch, an MLP
    half with two dispatches), a prefill chunk (a dispatch, then the
    boundary's sync) and a drain (a sync)."""
    t = 1000.0 * k

    def add(name, a, b, parent, **kw):
        recs.append(_rec(name, t + a, t + b, parent, **kw))
        return len(recs) - 1
    s = add("serve.step", 100, 900, -1)
    d = add("serve.decode", 110, 600, s)
    c = add("model.call", 120, 580, d, attrs={"which": "decode"})
    at = add("model.attention", 130, 300, c, attrs={"layer": 0})
    add("gemm.dispatch", 140, 180, at)
    add("serve.sync", 200, 250, at)
    m = add("model.mlp", 300, 560, c, attrs={"layer": 0})
    add("gemm.dispatch", 310, 350, m)
    add("gemm.dispatch", 360, 400, m)
    p = add("serve.prefill", 600, 850, s, rid=k,
            attrs=None if waited is None else {"waited_us": waited})
    c2 = add("model.call", 610, 800, p, attrs={"which": "prefill"})
    add("gemm.dispatch", 620, 660, c2)
    add("serve.sync", 810, 840, p)
    dr = add("serve.drain", 860, 890, s)
    add("serve.sync", 865, 885, dr)


def _serve_ctx(recs_out, shift=0.0, lead=0.0):
    """Two steps; the device idles only over [140, 160] and [1310, 1400]
    (program time).  ``shift`` moves the second harness step later,
    ``lead`` starts the first one earlier."""
    recs = []
    _serve_step(recs, 0, waited=3000.0)
    _serve_step(recs, 1, waited=5000.0)
    recs_out[:] = recs
    spans = [("perfbench.slice", OFF, OFF + 2100)]
    for k in range(2):
        a = OFF + 1000 * k + (shift if k == 1 else 0.0)
        # each harness step starts with its program step and ends 30 us
        # after it (the clients' poll)
        spans.append(("perfbench.step", a + 100 - (lead if k == 0 else 0),
                      a + 930))
    kern = [(0, 140), (160, 1310), (1400, 2100)]
    data = {"t0": OFF, "t1": OFF + 2100, "spans": spans,
            "kernels": [{"name": "k", "ts": OFF + a, "dur": b - a,
                         "cat": "kernel", "op": None, "dims": None}
                        for a, b in kern]}
    return {"kind": "serve", "slice": data, "slice_steps": 2}


@pytest.fixture
def program(monkeypatch):
    """The program's records, as ``hostspans.records`` hands them out."""
    recs = []
    monkeypatch.setattr(hostspans, "records", lambda: list(recs))
    return recs


def test_align_recovers_a_known_offset(program):
    ctx = _serve_ctx(program)
    off = hostspans.align(ctx["slice"], program, "serve.step")
    assert off == pytest.approx(OFF)
    cap = hostspans.capture(ctx, "serve", "serve.step")
    assert cap is not None and cap.steps == [0, 15]
    assert cap.ms(cap.of("serve.sync", inside="model.call")) == \
        pytest.approx(0.1)
    assert cap.ms(cap.of("serve.sync", outside="model.call")) == \
        pytest.approx(0.1)
    # a step whose program span began later in its harness span (the
    # harness's work before it) does not move the offset
    ctx = _serve_ctx(program, lead=300.0)
    assert hostspans.align(ctx["slice"], program, "serve.step") == \
        pytest.approx(OFF)


def test_a_misaligned_slice_is_refused(program):
    # one harness step 1 ms late: its program step sticks out of it
    ctx = _serve_ctx(program, shift=1000.0)
    assert hostspans.align(ctx["slice"], program, "serve.step") is None
    assert hostspans.capture(ctx, "serve", "serve.step") is None
    # steps that do not pair one to one
    ctx = _serve_ctx(program)
    ctx["slice"]["spans"].pop()
    assert hostspans.capture(ctx, "serve", "serve.step") is None
    ctx = _serve_ctx(program)
    ctx["slice_steps"] = 3
    assert hostspans.capture(ctx, "serve", "serve.step") is None


def test_dropped_records_or_no_recorder_read_nothing(monkeypatch):
    monkeypatch.setattr(obs, "span_drops", lambda: 1)
    assert hostspans.records() is None
    monkeypatch.delattr(obs, "span_drops")
    assert hostspans.records() is None       # a program with no recorder
    recs = []
    ctx = _serve_ctx(recs)
    for name in SERVE_READERS:
        assert spec.reader(name)(ctx) is None


@pytest.mark.parametrize("name,want", [
    ("engine_host_ms.serve", 0.1),     # 800 - 650 in calls - 50 in syncs
    ("model_host_ms.serve", 0.6),      # 650 in calls - 50 of sync in them
    ("gemm_dispatch_us.serve", 40.0),
    ("sync_wait_ms.serve", 0.1),
    ("dispatch_idle_ms.serve", 0.05),  # 20 + 40 + 40 us over two steps
    ("prefill_wait_ms.serve", 4.0),
])
def test_serve_readers_on_a_synthetic_slice(program, name, want):
    ctx = _serve_ctx(program)
    assert spec.reader(name)(ctx) == pytest.approx(want)
    # nothing to read: another kind of cell, or no traced slice
    assert spec.reader(name)(dict(ctx, kind="train")) is None
    assert spec.reader(name)(dict(ctx, slice=None)) is None


def test_serve_readers_with_nothing_in_the_spans(program):
    ctx = _serve_ctx(program)
    # no first chunk, no routed GEMM (the records keep their places)
    program[:] = [r._replace(attrs=None) if r.name == "serve.prefill" else
                  r._replace(name="other") if r.name == "gemm.dispatch"
                  else r for r in program]
    assert spec.reader("prefill_wait_ms.serve")(ctx) is None
    assert spec.reader("gemm_dispatch_us.serve")(ctx) is None
    assert spec.reader("dispatch_idle_ms.serve")(ctx) == 0.0
    ctx["slice"]["kernels"] = []
    assert spec.reader("dispatch_idle_ms.serve")(ctx) is None


def _train_ctx(recs_out, dev=(40.0, 2.5)):
    recs = []
    for k in range(2):
        t = 10_000.0 * k
        recs.append(_rec("train.step", t + 100, t + 9000))
        s = len(recs) - 1
        recs.append(_rec("train.grads", t + 200, t + 7000, s, dev=dev[0]))
        recs.append(_rec("model.attention", t + 300, t + 900, s + 1,
                         attrs={"layer": 0}))
        recs.append(_rec("train.optimizer", t + 7100, t + 8900, s,
                         dev=dev[1]))
    recs_out[:] = recs
    spans = [("perfbench.slice", OFF, OFF + 20_000)] + [
        ("perfbench.step", OFF + 10_000 * k + 50, OFF + 10_000 * k + 9050)
        for k in range(2)]
    return {"kind": "train", "slice_steps": 2,
            "slice": {"t0": OFF, "t1": OFF + 20_000, "spans": spans,
                      "kernels": []}}


def test_optimizer_reader_on_a_synthetic_slice(program):
    read = spec.reader("optimizer_ms.train")
    ctx = _train_ctx(program)
    assert read(ctx) == pytest.approx(2.5)
    assert read(dict(ctx, kind="serve")) is None
    _train_ctx(program, dev=(40.0, None))      # no device time (the CPU)
    assert read(ctx) is None


def test_traced_cpu_runs_read_the_new_metrics():
    """The harness's own traced slice, on the CPU: the spans line up
    with its steps, the host-time metrics add up to the program's steps,
    and what needs a device trace or device time reads nothing."""
    bench = spec.load_benchmark()
    obs.reset()
    # a slice of 16 steps holds first prefill chunks
    res = serve.run(smoke("olmo-1b"), small_chat(trace_steps=16),
                    spec.limits("olmo-1b.chat-32"), 2 ** 31 + 77, 3.0, True,
                    device="cpu")
    ctx = res["ctx"]
    got = spec.read_metrics(bench, "olmo-1b.chat-32", ctx)
    assert obs.span_drops() == 0
    for name in SERVE_READERS:
        if name != "dispatch_idle_ms.serve":       # no device on the CPU
            assert got[name] >= 0, name
    assert "dispatch_idle_ms.serve" not in got
    cap = hostspans.capture(ctx, "serve", "serve.step")
    steps = cap.ms([cap.recs[i] for i in cap.steps]) / len(cap.steps)
    total = got["engine_host_ms.serve"] + got["model_host_ms.serve"] + \
        got["sync_wait_ms.serve"]
    assert total == pytest.approx(steps)
    assert total <= got["decode_step_ms.serve"]
    obs.reset()
    res = train.run(smoke("olmo-1b", dtype="float32"), small_train(),
                    spec.limits("olmo-1b.train-8x2048"), 5, 1.0, True,
                    device="cpu")
    assert hostspans.capture(res["ctx"], "train", "train.step") is not None
    got = spec.read_metrics(bench, "olmo-1b.train-8x2048", res["ctx"])
    assert "optimizer_ms.train" not in got        # no device time
    obs.reset()
