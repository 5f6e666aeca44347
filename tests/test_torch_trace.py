"""The port's flight-recorder consumers against the JAX package's: the
per-request reducer, its summary and registry fold, the Perfetto export
and the trace file, on one event list.  The event tuples are the same in
both packages, so one list must give equal dicts and identical JSON."""
import json
import random

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs import trace as jtrace
from repro_torch import api, configs, obs
from repro_torch.models import registry
from repro_torch.obs import __main__ as obs_cli
from repro_torch.obs import trace
from repro_torch.serve import PagedEngine, Request

_T = 1e-3


@pytest.fixture(autouse=True)
def _clean_obs():
    for o in (obs, jobs):
        o.set_enabled(True)
        o.reset()
    yield
    for o in (obs, jobs):
        o.set_enabled(True)
        o.reset()


def _stream():
    """Two requests, one preempted before and after its first token, and
    every batch-wide event kind, the tuner's cycles included."""
    return [
        (0 * _T, "REQ_ARRIVE", 7, -1, (10, 4), None),
        (0.1 * _T, "PROFILE_SWAP", -1, -1, "cpu/cpu:3", None),
        (0.5 * _T, "REQ_ARRIVE", 8, -1, (4, 2), None),
        (2 * _T, "ADMIT", 7, 0, None, None),
        (2.5 * _T, "ROUTE_MISS", -1, -1,
         ("gemm", "S", "NN", [4, 8, 8], "analytical"), None),
        (3 * _T, "PREFILL_CHUNK", 7, 0, (0, 10), 500.0),
        (4 * _T, "PREEMPT", 7, 0, None, None),
        (4.5 * _T, "ADMIT", 8, 0, None, None),
        (5.0 * _T, "FIRST_TOKEN", 8, 0, None, None),
        (5.2 * _T, "TUNE_CYCLE", -1, -1, (1, 2, 4, True), 2500.0),
        (5.5 * _T, "FINISH", 8, 0, 2, None),
        (6 * _T, "RESUME", 7, 1, None, None),
        (7 * _T, "FIRST_TOKEN", 7, 1, None, None),
        (7.5 * _T, "DECODE_TICK", -1, -1, (8, 1), None),
        (8 * _T, "PREEMPT", 7, 1, None, None),
        (9 * _T, "EVICT", 7, -1, 2, None),
        (9.5 * _T, "TUNE_CYCLE", -1, -1, (2, 0, 0, False), None),
        (11 * _T, "RESUME", 7, 2, None, None),
        (12 * _T, "FINISH", 7, 2, 4, None),
    ]


def _random_stream(seed, n_req=6):
    """A random but well-formed lifecycle per request, interleaved."""
    rng = random.Random(seed)
    evs, t = [], 0.0
    for rid in range(n_req):
        t0 = rng.uniform(0, 5e-3)
        seq = [(t0, "REQ_ARRIVE", rid, -1, (rng.randint(2, 30), 8), None)]
        t = t0
        first = False
        for _ in range(rng.randint(1, 3)):
            t += rng.uniform(1e-4, 2e-3)
            slot = rng.randint(0, 3)
            seq.append((t, "RESUME" if len(seq) > 1 else "ADMIT", rid, slot,
                        None, None))
            t += rng.uniform(1e-4, 1e-3)
            seq.append((t, "PREFILL_CHUNK", rid, slot, (0, 8),
                        rng.uniform(10, 900)))
            if not first or rng.random() < 0.5:
                t += rng.uniform(1e-4, 1e-3)
                seq.append((t, "FIRST_TOKEN", rid, slot, None, None))
                first = True
            t += rng.uniform(1e-4, 1e-3)
            seq.append((t, "PREEMPT", rid, slot, None, None))
        t += rng.uniform(1e-4, 1e-3)
        seq.append((t, "RESUME", rid, 0, None, None))
        if rng.random() < 0.8:          # some never finish in the window
            t += rng.uniform(1e-4, 1e-3)
            seq.append((t, "FINISH", rid, 0, rng.randint(1, 8), None))
        evs.extend(seq)
    for i in range(4):
        evs.append((rng.uniform(0, t), "TUNE_CYCLE", -1, -1,
                    (i + 1, 1, 2, True), rng.uniform(100, 5000)))
    rng.shuffle(evs)
    return evs


@pytest.mark.parametrize("events", ["fixed", 0, 1, 2],
                         ids=["fixed", "random0", "random1", "random2"])
def test_reducer_summary_and_perfetto_equal_the_reference(events):
    evs = _stream() if events == "fixed" else _random_stream(events)
    per = trace.per_request(evs)
    assert per == jtrace.per_request(evs)
    assert trace.summary(per) == jtrace.summary(per)
    for slots in (None, 4):
        got = json.dumps(trace.perfetto(evs, slots=slots), sort_keys=True)
        want = json.dumps(jtrace.perfetto(evs, slots=slots), sort_keys=True)
        assert got == want
    trace.observe(per)
    jtrace.observe(per)
    assert obs.REGISTRY.snapshot() == jobs.REGISTRY.snapshot()


def test_reducer_splits_ttft_and_decode_stall():
    r7 = trace.per_request(_stream())[7]
    assert r7["preemptions"] == 2 and r7["finished"] and r7["n_out"] == 4
    assert r7["queue_wait_us"] == pytest.approx(2000, abs=0.1)
    assert r7["ttft_wait_us"] == pytest.approx(4000, abs=0.1)
    assert r7["ttft_prefill_us"] == pytest.approx(3000, abs=0.1)
    assert r7["decode_stall_us"] == pytest.approx(3000, abs=0.1)
    s = trace.summary(trace.per_request(_stream()))
    assert s["requests"] == 2 and s["finished"] == 2


def test_perfetto_tuner_track_and_empty_stream():
    doc = trace.perfetto(_stream(), slots=3)
    te = doc["traceEvents"]
    cyc = [e for e in te if e["name"] == "tune_cycle"]
    assert [(e["ph"], e["pid"], e["tid"]) for e in cyc] == \
        [("X", 2, 1), ("i", 2, 1)]
    assert cyc[0]["dur"] == 2500.0 and cyc[0]["ts"] == \
        pytest.approx(5200 - 2500)
    tracks = {e["args"]["name"] for e in te
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"queue", "slot 0", "slot 1", "slot 2", "online tuner"} <= tracks
    assert trace.perfetto([]) == jtrace.perfetto([]) == {
        "traceEvents": [], "displayTimeUnit": "ms"}


def test_event_log_taxonomy_and_drops():
    assert trace.EVENT_TYPES == jtrace.EVENT_TYPES
    assert "TUNE_CYCLE" in trace.EVENT_TYPES
    log = trace.EventLog(capacity=3)
    for i in range(5):
        log.emit("DECODE_TICK", arg=(i, 1))
    assert len(log) == 3 and log.dropped == 2
    assert [e[4][0] for e in log.snapshot()] == [2, 3, 4]
    with pytest.raises(ValueError, match="unknown trace event"):
        log.emit("NOT_AN_EVENT")
    log.set_enabled(False)
    log.emit("DECODE_TICK")
    assert log.n_total == 5
    log.reset()
    assert len(log) == 0 and log.dropped == 0


def test_trace_file_round_trips_across_packages(tmp_path):
    """The port's file loads in both packages; the reference's file in
    the port; re-exporting either gives the same document."""
    evs = _stream()
    p = trace.write_trace(tmp_path / "t.json", evs, slots=3)
    q = jtrace.write_trace(tmp_path / "j.json", evs, slots=3)
    a, b = json.loads(p.read_text()), json.loads(q.read_text())
    b["reproTrace"]["capacity"] = a["reproTrace"]["capacity"]
    assert a == b
    back = trace.load_events(p)
    assert back == jtrace.load_events(p) == trace.load_events(q)
    assert trace.per_request(back) == trace.per_request(evs)
    p2 = trace.write_trace(tmp_path / "t2.json", back, slots=3)
    assert json.loads(p2.read_text()) == a
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(ValueError, match="no reproTrace"):
        trace.load_events(bad)
    bad.write_text(json.dumps({"reproTrace": {"schema": 9, "events": []}}))
    with pytest.raises(ValueError, match="schema"):
        trace.load_events(bad)


def test_cli_trace_reexport_and_live_ring(tmp_path, capsys):
    p = trace.write_trace(tmp_path / "in.json", _stream(), slots=3)
    out = tmp_path / "out.json"
    assert obs_cli.main(["trace", str(p), str(out)]) == 0
    text = capsys.readouterr().out
    assert "wrote" in text and "queue_wait_us" in text
    assert json.loads(out.read_text()) == json.loads(p.read_text())
    live = tmp_path / "live.json"
    assert obs_cli.main(["trace", str(live)]) == 0
    assert "live flight recorder is empty" in capsys.readouterr().out
    obs.TRACE.emit("REQ_ARRIVE", rid=1, arg=(3, 2))
    assert obs_cli.main(["trace", str(live)]) == 0
    assert trace.load_events(live)[0][1] == "REQ_ARRIVE"


def test_port_engine_trace_reduces_alike_in_both_packages():
    """A preemption-forcing serve on the port's engine: its own events,
    reduced and exported by both packages, agree; the reducer's counts
    agree with the engine's."""
    cfg = configs.get_smoke("olmo-1b")
    model = registry.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(2)
    # 3 usable blocks x 8 < peak demand: the younger request preempts
    e = PagedEngine(model, params, api.Policy(backend="kernel"), slots=2,
                    max_len=24, eos=-1, block_size=8, chunk=8, num_blocks=4,
                    device="cpu")
    for rid in range(2):
        e.submit(Request(rid, rng.randint(0, cfg.vocab, 7), max_new=10))
    done = e.run()
    assert len(done) == 2
    evs = obs.TRACE.snapshot()
    assert {"REQ_ARRIVE", "ADMIT", "PREFILL_CHUNK", "FIRST_TOKEN",
            "PREEMPT", "RESUME", "FINISH", "EVICT"} <= {x[1] for x in evs}
    per = trace.per_request(evs)
    assert per == jtrace.per_request(evs)
    assert all(r["finished"] and r["n_out"] == 10 for r in per.values())
    assert sum(r["preemptions"] for r in per.values()) == \
        obs.counter("serve.preemptions").value > 0
    assert json.dumps(trace.perfetto(evs, slots=2), sort_keys=True) == \
        json.dumps(jtrace.perfetto(evs, slots=2), sort_keys=True)


def test_reexport_is_identical_for_host_clock_times(tmp_path):
    """A wait that the host clock puts just under a 0.05 µs boundary
    (2000.04996 µs): the file keeps times to 1 ns, and its per-request
    metrics (0.1 µs) and slices come from the times as it keeps them, so
    a re-export of the file is the same document (metrics taken from the
    raw times put the two documents' waits 0.1 µs apart)."""
    evs = [(81234.5678 + t, *rest) for t, *rest in _stream()]
    i = next(i for i, e in enumerate(evs) if e[1] == "ADMIT")
    evs[i] = (81234.5678 + 2000.04996e-6, *evs[i][1:])
    p = trace.write_trace(tmp_path / "host.json", evs, slots=3)
    again = trace.write_trace(tmp_path / "again.json",
                              trace.load_events(p), slots=3)
    assert json.loads(again.read_text()) == json.loads(p.read_text())
