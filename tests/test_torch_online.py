"""The port's online re-tuner (``repro_torch.tune.online``) against the
JAX package's, and what the port adds around it: the traffic weighting
(equal to the reference's), the budget, merge provenance, the background
thread, the engine's one-profile-per-step rule, the online-swap token
parity of the reference's serving fuzz test, the stream-local timer and
the split-K tickets per stream."""
import dataclasses
import json
import random
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.tune import online as jonline
from repro_torch import api, configs, obs
from repro_torch.core import kernelgen
from repro_torch.core.kernelgen import KernelSig
from repro_torch.kernels import grouped_gemm as gg, iaat_gemm
from repro_torch.launch import serve as serve_mod
from repro_torch.models import lm, registry
from repro_torch.serve import PagedEngine, Request
from repro_torch.tune import classes, online, profile as profile_mod, search
from repro_torch.tune import timer
from repro_torch.tune.classes import SizeClass
from repro_torch.tune.online import OnlineTuner, weighted_targets
from repro_torch.tune.profile import DeviceProfile, ProfileEntry
from repro_torch.tune.search import TuneTarget
from repro_torch.tune.timer import Measurement

TUNED = api.Policy(backend="tuned")
SIG = kernelgen.kernel_table("S", "NN")[0]


@pytest.fixture(autouse=True)
def _isolated_state(tmp_path, monkeypatch):
    """Empty tune cache, no active profile, clean obs — before and after."""
    monkeypatch.setenv(profile_mod.CACHE_ENV, str(tmp_path / "cache"))
    obs.set_enabled(True)
    obs.reset()
    profile_mod.clear_active_profile()
    obs.TRACE.reset()
    yield
    profile_mod.clear_active_profile()
    obs.set_enabled(True)
    obs.reset()


def _m(us: float) -> Measurement:
    return Measurement(us, us, us, 1)


def _entry(kernel_us=None, library_us=None, sig=SIG, origin="sweep"):
    return ProfileEntry(sig, _m(kernel_us) if kernel_us else None,
                        _m(library_us) if library_us else None, origin)


def _here() -> DeviceProfile:
    return DeviceProfile(profile_mod.current_device_kind(),
                         mode=profile_mod.current_mode())


# -- traffic weighting: the reference's function ----------------------------

@pytest.mark.parametrize("seed", range(4))
def test_weighted_targets_equal_the_reference(seed):
    rng = random.Random(seed)
    ops = ("gemm", "matmul", "batched_gemm", "ragged_gemm")
    folded = {(rng.choice(ops), rng.choice("SDH"),
               "-".join(str(rng.randint(0, 15)) for _ in range(3))):
              rng.uniform(0.0, 50.0) for _ in range(40)}
    done = {}
    for (op, letter, cls) in list(folded)[:10]:
        kind = "grouped" if op in ("batched_gemm", "ragged_gemm") else "gemm"
        done[(kind, f"{letter}/NN/{cls}")] = rng.uniform(0.0, 40.0)
    for kw in ({}, {"min_weight": 5.0}, {"done": done},
               {"done": done, "retune_ratio": 1.1, "top_k": 5},
               {"max_dim": 1024}, {"max_dim": 16384, "top_k": 3}):
        got = [(t.kind, t.sc.key, t.weight)
               for t in weighted_targets(folded, **kw)]
        want = [(t.kind, t.sc.key, t.weight)
                for t in jonline.weighted_targets(folded, **kw)]
        assert got == want


def test_weighted_targets_kinds_hysteresis_and_valve():
    folded = {("gemm", "S", "3-3-3"): 10.0, ("matmul", "S", "3-3-3"): 5.0,
              ("batched_gemm", "S", "2-4-4"): 3.0,
              ("ragged_gemm", "S", "2-4-4"): 1.0,
              ("gemm", "S", "2-4-4"): 2.0, ("gemm", "S", "4-4-4"): 0.25}
    ts = weighted_targets(folded)
    assert [(t.kind, t.sc.key, t.weight) for t in ts] == [
        ("gemm", "S/NN/3-3-3", 15.0), ("grouped", "S/NN/2-4-4", 4.0),
        ("gemm", "S/NN/2-4-4", 2.0)]
    done = {("gemm", "S/NN/3-3-3"): 10.0}
    assert [t.sc.key for t in weighted_targets(folded, done=done)][0] == \
        "S/NN/2-4-4"                       # 15 <= 1.5 * 10: steady
    folded[("gemm", "S", "8-8-8")] = 1000.0
    assert all(t.sc.key != "S/NN/8-8-8"
               for t in weighted_targets(folded, max_dim=64))


# -- budget and merge provenance ----------------------------------------------

def test_budgeted_sweep_enforces_the_budget(monkeypatch):
    calls = [0]

    def fake_measure(fn, **kw):
        calls[0] += 1
        return _m(1.0)
    monkeypatch.setattr(search, "try_measure", fake_measure)
    targets = [TuneTarget("gemm", SizeClass("S", "NN", i, i, i), 10.0 - i)
               for i in range(2, 7)]
    prof, tuned, spent = search.budgeted_sweep(targets, budget=4, top=1,
                                               device="cpu")
    # each class costs the library + the top candidate: budget 4 covers
    # the two hottest, and the sweep stops before a class it cannot finish
    assert len(tuned) == 2 and spent == 4 and calls[0] <= 4
    assert [t.sc.key for t in tuned] == ["S/NN/2-2-2", "S/NN/3-3-3"]
    assert len(prof) == 2 and prof.mode == "cpu"
    assert all(e.origin == "online" for e in prof.entries.values())


def test_budgeted_sweep_records_the_grouped_namespace(monkeypatch):
    monkeypatch.setattr(search, "try_measure", lambda fn, **kw: _m(1.0))
    sc = SizeClass("S", "NN", 2, 4, 4)
    prof, tuned, _ = search.budgeted_sweep(
        [TuneTarget("grouped", sc, 5.0)], budget=8, top=1, device="cpu")
    assert prof.lookup(sc) is None
    e = prof.lookup_grouped(sc)
    assert e is not None and e.measured and e.origin == "online"
    assert DeviceProfile.from_json(prof.to_json()).lookup_grouped(sc)


# -- the cycle ----------------------------------------------------------------

def _route_traffic(n=3):
    r = api.Router(api.Policy(backend="auto"))
    for _ in range(n):
        r.route("gemm", (45, 45, 45), "S", "NN")
        r.route("batched_gemm", (4, 8, 16, 24), "S", "NN")


def _stub_sweeper(kernel_us=1.0, library_us=2.0, sig=SIG):
    """A sweeper double honouring the budgeted_sweep contract."""
    def sweeper(targets, *, budget):
        prof = _here()
        tuned, spent = [], 0
        for t in targets:
            if spent + 2 > budget:
                break
            e = _entry(kernel_us, library_us, sig=sig, origin="online")
            (prof.record_grouped if t.kind == "grouped"
             else prof.record)(t.sc, e)
            tuned.append(t)
            spent += 2
        return prof, tuned, spent
    return sweeper


def test_cycle_retunes_merges_and_swaps():
    _route_traffic()
    tn = OnlineTuner(sweeper=_stub_sweeper(sig=KernelSig("S", "NN", 16,
                                                         128, 64)),
                     budget=8)
    assert tn.mode == profile_mod.current_mode()
    gen0, pgen0 = obs.ROUTES.gen, profile_mod.generation()
    rep = tn.cycle()
    assert (rep.cycle, rep.considered, rep.retuned, rep.timings,
            rep.swapped) == (1, 2, 2, 4, True)
    prof = profile_mod.active_profile()
    assert prof is not None and len(prof) == 2
    assert obs.ROUTES.gen > gen0 and profile_mod.generation() > pgen0
    evs = obs.TRACE.snapshot()
    assert {"TUNE_CYCLE", "PROFILE_SWAP"} <= {e[1] for e in evs}
    cyc = [e for e in evs if e[1] == "TUNE_CYCLE"][-1]
    assert cyc[4] == (1, 2, 4, True) and cyc[5] > 0
    assert obs.counter("tune.online.cycles").value == 1
    assert obs.counter("tune.online.classes_retuned").value == 2
    assert obs.counter("tune.online.swaps").value == 1
    assert obs.REGISTRY.get("tune.online.cycle_us").count == 1
    d = api.route("gemm", (45, 45, 45), "S", "NN", policy=TUNED)
    assert d.source == "profile" and d.use_kernel
    d = api.route("batched_gemm", (4, 8, 16, 24), "S", "NN", policy=TUNED)
    assert d.source == "profile" and d.blocks == (16, 128, 64)


def test_cycle_without_traffic_is_a_quiet_noop():
    rep = OnlineTuner(sweeper=_stub_sweeper()).cycle()
    assert rep.retuned == 0 and not rep.swapped
    types = [e[1] for e in obs.TRACE.snapshot()]
    assert "PROFILE_SWAP" not in types and "TUNE_CYCLE" in types
    assert profile_mod.active_profile() is None


def test_cycle_steady_traffic_tunes_once(monkeypatch):
    """The reference's case (the same traffic, no new calls) and the
    port's: the route log counts executions, so steady serving keeps
    adding calls at one rate across many buckets; it is tuned once, and
    a shift in the mix re-tunes."""
    _route_traffic()
    tn = OnlineTuner(sweeper=_stub_sweeper(), budget=8)
    assert tn.cycle().retuned == 2
    rep2 = tn.cycle()
    assert rep2.retuned == 0 and not rep2.swapped

    obs.reset()
    clock = [100.0]
    windowed = obs.ROUTES.windowed
    monkeypatch.setattr(obs.ROUTES, "windowed",
                        lambda n, **kw: windowed(n, now=clock[0], **kw))
    r = api.Router(api.Policy(backend="auto"))
    tn = OnlineTuner(sweeper=_stub_sweeper(), budget=8)
    retuned = []
    for step in range(12):
        for _ in range(20):                      # one second of serving
            r.route("gemm", (45, 45, 45), "S", "NN")
            for _ in range(3):
                r.route("matmul", (4, 1, 64, 256), "S")
        clock[0] += 0.5 + 0.5 * (step % 2)       # uneven polling
        retuned.append(tn.cycle().retuned)
    assert retuned[0] == 2 and sum(retuned) == 2
    for _ in range(10):                          # the mix shifts
        clock[0] += 1.0
        for _ in range(60):
            r.route("gemm", (45, 45, 45), "S", "NN")
        for _ in range(3):
            r.route("matmul", (4, 1, 64, 256), "S")
        retuned.append(tn.cycle().retuned)
    # the shifted class re-tunes as its share climbs, then settles
    assert sum(retuned[12:]) >= 1 and retuned[-4:] == [0, 0, 0, 0]


def test_cycle_mode_mismatch_skips_the_merge(monkeypatch):
    _route_traffic()
    live = DeviceProfile(profile_mod.current_device_kind(), mode="cuda")
    live.record(SizeClass("S", "NN", 1, 1, 1), _entry(1.0, 2.0))
    monkeypatch.setattr(profile_mod, "_check_applies", lambda p: None)
    profile_mod.set_active_profile(live)
    tn = OnlineTuner(sweeper=_stub_sweeper(), budget=8)   # a cpu delta
    rep = tn.cycle()
    assert rep.retuned == 2 and not rep.swapped
    assert profile_mod.active_profile() is live
    assert obs.counter("tune.online.merge_skips").value == 1


def test_real_cycle_on_the_cpu_retimes_a_grouped_class():
    """No stub: moonshot-smoke's batched traffic through one synchronous
    cycle times the grouped kernel's plain version against the einsum
    and publishes an online grouped entry (the chip smoke's "online
    grouped" phase, on the CPU)."""
    r = api.Router(api.Policy(backend="auto"))
    for _ in range(4):
        r.route("batched_gemm", (8, 12, 64, 64), "S")
    tn = OnlineTuner(budget=4, device="cpu")
    rep = tn.cycle()
    assert rep.retuned == 1 and rep.swapped
    e = profile_mod.active_profile().lookup_grouped(
        classes.size_class(12, 64, 64, "S", "NN"))
    assert e is not None and e.origin == "online" and e.measured
    assert e.kernel is not None and e.kernel.median_us > 0


# -- the background thread ------------------------------------------------------

def test_kill_switch_disables_start(monkeypatch):
    monkeypatch.setenv(online.KILL_SWITCH_ENV, "0")
    assert not online.enabled()
    tn = OnlineTuner(sweeper=_stub_sweeper())
    assert tn.start() is False and not tn.running
    assert tn.stop()
    monkeypatch.delenv(online.KILL_SWITCH_ENV)
    assert online.enabled()


def test_background_thread_cycles_and_stops_clean():
    _route_traffic()
    tn = OnlineTuner(sweeper=_stub_sweeper(), interval_s=0.01, budget=8)
    assert tn.start() and tn.running
    assert tn.start()
    deadline = time.time() + 5.0
    while tn.cycles < 2 and time.time() < deadline:
        time.sleep(0.01)
    assert tn.cycles >= 2
    assert tn.stop() and not tn.running
    n = tn.cycles
    time.sleep(0.05)
    assert tn.cycles == n
    assert tn.start() and tn.running
    assert tn.stop()


def test_context_manager_runs_and_joins():
    _route_traffic()
    with OnlineTuner(sweeper=_stub_sweeper(), interval_s=0.01) as tn:
        deadline = time.time() + 5.0
        while tn.cycles < 1 and time.time() < deadline:
            time.sleep(0.01)
    assert not tn.running and tn.cycles >= 1


def test_errors_are_counted_and_never_raised_into_serving():
    _route_traffic()

    def broken(targets, *, budget):
        raise RuntimeError("the stopwatch broke")
    tn = OnlineTuner(sweeper=broken, interval_s=0.01)
    assert tn.start()
    deadline = time.time() + 5.0
    while obs.counter("tune.online.errors").value < 2 and \
            time.time() < deadline:
        time.sleep(0.01)
    assert tn.stop()
    assert obs.counter("tune.online.errors").value >= 2
    assert profile_mod.active_profile() is None


def test_the_sweep_runs_on_the_tuners_own_stream(monkeypatch):
    """On the card every candidate is timed inside torch.cuda.stream(...)
    of one stream the tuner owns (stubbed here: no card)."""
    made, entered = [], []

    class FakeStream:
        def __init__(self, device):
            made.append(self)

    class FakeContext:
        def __init__(self, s):
            self.s = s

        def __enter__(self):
            entered.append(self.s)

        def __exit__(self, *exc):
            entered.append(None)

    seen = []

    def fake_sweep(targets, **kw):
        seen.append((entered[-1], kw["device"].type))
        return _here(), [], 0
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "stream", FakeContext)
    monkeypatch.setattr(search, "budgeted_sweep", fake_sweep)
    tn = OnlineTuner(device="cuda")
    t = [TuneTarget("gemm", SizeClass("S", "NN", 5, 5, 5), 3.0)]
    tn._sweep(t)
    tn._sweep(t)
    assert len(made) == 1
    assert seen == [(made[0], "cuda"), (made[0], "cuda")]
    assert entered[-1] is None


def test_router_readers_survive_a_profile_swap_hammer():
    """Reader threads routing under ``tuned`` race a thread publishing two
    profiles in a loop: no exception, every decision from a profile."""
    sc = classes.size_class(45, 45, 45, "S", "NN")
    profs = []
    for k_us, l_us in ((1.0, 9.0), (9.0, 1.0)):
        p = _here()
        p.record(sc, _entry(k_us, l_us))
        profs.append(p)
    errors, stop = [], threading.Event()

    def hammer():
        i = 0
        while not stop.is_set():
            profile_mod.set_active_profile(profs[i % 2])
            i += 1

    def read(tid):
        try:
            r = api.Router(TUNED)
            for i in range(300):
                m = 8 + ((tid * 300 + i) % 61)
                assert r.route("gemm", (m, m, m), "S", "NN").source in (
                    "profile", "analytical")
                assert r.route("gemm", (45, 45, 45), "S",
                               "NN").source == "profile"
        except Exception as e:                        # pragma: no cover
            errors.append(e)

    readers = [threading.Thread(target=read, args=(t,)) for t in range(4)]
    h = threading.Thread(target=hammer)
    h.start()
    for t in readers:
        t.start()
    for t in readers:
        t.join(timeout=60)
    stop.set()
    h.join(timeout=60)
    assert not errors and not h.is_alive()
    assert not any(t.is_alive() for t in readers)


# -- the engine: one profile per step -----------------------------------------

@pytest.fixture(scope="module")
def smoke_f32():
    """olmo-smoke in f32: the JAX package's weights carried into the port."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("olmo-1b"),
                               dtype="float32")
    tree = jax.tree.map(np.asarray,
                        jregistry.build(jcfg).init(jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(configs.get_smoke("olmo-1b"), dtype="float32")
    return cfg, registry.build(cfg), lm.params_from_numpy(tree, cfg,
                                                          device="cpu")


def _trace_inputs(cfg, seed=42, n=6):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab, int(rng.randint(2, 28)))
               for _ in range(n)]
    maxnew = [int(rng.randint(2, 10)) for _ in range(n)]
    return prompts, maxnew, np.cumsum(rng.poisson(2, size=n))


def _engine(model, params, tuner=None):
    # 7 usable blocks of 8 for 3 slots: preemption pressure
    return PagedEngine(model, params, TUNED, slots=3, max_len=64, eos=-1,
                       block_size=8, chunk=8, num_blocks=8, tuner=tuner,
                       device="cpu")


def _pref_profiles(counts):
    """Two profiles over every class the model routed: p1 prefers the
    kernel, p2 the library."""
    out = []
    for k_us, l_us in ((1.0, 9.0), (9.0, 1.0)):
        p = _here()
        for (op, letter, cls) in counts:
            p.record(SizeClass.from_key(f"{letter}/NN/{cls}"),
                     _entry(k_us, l_us, origin="online"))
        out.append(p)
    return out


def test_online_swap_token_parity(smoke_f32):
    """Profile swaps mid-stream — a real background tuner AND manual
    ``set_active_profile`` calls between steps — leave the f32 tokens of
    the paged engine under ``tuned`` identical to a run with no swap,
    while the routing decisions of the model's classes really flip."""
    cfg, model, params = smoke_f32
    prompts, maxnew, arrivals = _trace_inputs(cfg)
    n = len(prompts)

    def drive(e, before_step=lambda t: None):
        t, nxt = 0, 0
        while nxt < n:
            while nxt < n and arrivals[nxt] <= t:
                e.submit(Request(nxt, prompts[nxt], max_new=maxnew[nxt]))
                nxt += 1
            before_step(t)
            e.step()
            t += 1
        return e.run()

    ref = drive(_engine(model, params))
    p1, p2 = _pref_profiles(obs.ROUTES.shape_counts())

    def sweeper(targets, *, budget):
        delta = _here()
        tuned = []
        for t in targets[: budget // 2]:
            (delta.record_grouped if t.kind == "grouped"
             else delta.record)(t.sc, _entry(1.0, 2.0, origin="online"))
            tuned.append(t)
        return delta, tuned, 2 * len(tuned)

    obs.reset()
    tuner = OnlineTuner(interval_s=0.02, budget=4, sweeper=sweeper)
    e = _engine(model, params, tuner)
    assert tuner.start()
    stopped = []

    def before_step(t):
        if t == 2:
            profile_mod.set_active_profile(p1)
        elif t == 5:
            profile_mod.set_active_profile(p2)
        elif t == 7 and not stopped:
            time.sleep(0.05)                 # let a cycle land
            assert tuner.stop(timeout=10.0)
            stopped.append(True)
    out = drive(e, before_step)
    assert stopped and not tuner.running
    assert out == ref
    assert e.cache.blocks_in_use == 0
    assert len([v for v in obs.TRACE.snapshot()
                if v[1] == "PROFILE_SWAP"]) >= 2
    assert tuner.cycles >= 1
    assert len(e.steps_by_gen) >= 3
    # the decisions the stream survived really differ between p1 and p2
    op, letter, cls = next(k for k in obs.ROUTES.shape_counts()
                           if k[0] == "matmul")
    M, N, K = classes.representative(SizeClass.from_key(
        f"{letter}/NN/{cls}"))
    profile_mod.set_active_profile(p1)
    d1 = api.route("gemm", (M, N, K), letter, "NN", policy=TUNED)
    profile_mod.set_active_profile(p2)
    d2 = api.route("gemm", (M, N, K), letter, "NN", policy=TUNED)
    assert d1.source == d2.source == "profile"
    assert d1.use_kernel and not d2.use_kernel


def test_no_step_sees_two_profiles(smoke_f32, monkeypatch):
    """A sweeper that publishes profiles in a tight loop from the tuner's
    thread while the engine serves: every profile read of a step is of one
    profile, and the swaps land between steps."""
    cfg, model, params = smoke_f32
    prompts, maxnew, _ = _trace_inputs(cfg, seed=7, n=8)
    _engine(model, params).run()            # routes the model's classes
    p1, p2 = _pref_profiles(obs.ROUTES.shape_counts())
    published = [0]

    def swapping_sweeper(targets, *, budget):
        for i in range(50):
            profile_mod.set_active_profile((p1, p2)[i % 2])
            published[0] += 1
        return p1, list(targets), 2 * len(targets)

    tuner = OnlineTuner(interval_s=0.001, retune_ratio=0.0,
                        sweeper=swapping_sweeper)
    e = _engine(model, params, tuner)
    seen = []
    real = profile_mod.active_profile
    main = threading.get_ident()

    def spy():
        p = real()
        if threading.get_ident() == main:
            seen.append((sum(e.steps_by_gen.values()), id(p)))
        return p
    monkeypatch.setattr(profile_mod, "active_profile", spy)
    for rid in range(len(prompts)):
        e.submit(Request(rid, prompts[rid], max_new=maxnew[rid]))
    assert tuner.start()            # the engine's polls wait meanwhile
    try:
        out = e.run()
    finally:
        assert tuner.stop()
    assert len(out) == len(prompts)
    assert published[0] >= 50
    per_step = {}
    for step, pid in seen:
        per_step.setdefault(step, set()).add(pid)
    assert per_step and all(len(v) == 1 for v in per_step.values())
    assert len({next(iter(v)) for v in per_step.values()}) >= 2
    assert len(e.steps_by_gen) >= 2


def test_pinned_defers_a_swap_to_the_end_of_the_step():
    p = _here()
    with profile_mod.pinned() as gen:
        profile_mod.set_active_profile(p)
        assert profile_mod.generation() == gen
        assert profile_mod.active_profile() is None
        assert profile_mod.latest_profile() is p
        with profile_mod.pinned() as inner:        # nested: still held
            assert inner == gen
        assert profile_mod.active_profile() is None
    assert profile_mod.generation() == gen + 1
    assert profile_mod.active_profile() is p
    profile_mod.set_active_profile(None)          # unpinned: at once
    assert profile_mod.generation() == gen + 2


def test_engine_run_starts_and_stops_the_tuner(smoke_f32):
    """The engine drives its tuner from its own loop: it polls after every
    step, on its own thread, and starts no background loop, so nothing of
    the tuner runs beside a step or outlives run(), on drain or on a
    raise."""
    cfg, model, params = smoke_f32

    class Spy:
        running = False
        calls = []

        def start(self):
            self.calls.append("start")
            return True

        def stop(self, timeout=30.0):
            self.calls.append("stop")
            return True

        def poll(self):
            self.calls.append(("poll", threading.get_ident(),
                               sum(e.steps_by_gen.values())))

    spy = Spy()
    e = _engine(model, params, spy)
    e.submit(Request(0, np.arange(3), max_new=2))
    assert len(e.run()) == 1
    steps = sum(e.steps_by_gen.values())
    assert steps > 0 and spy.calls == [
        ("poll", threading.get_ident(), i) for i in range(1, steps + 1)]
    e.submit(Request(1, np.arange(3), max_new=2))
    e.model = None                                 # the step raises
    with pytest.raises(AttributeError):
        e.run()
    assert not [c for c in spy.calls if c in ("start", "stop")]
    assert len(spy.calls) == steps


def test_serve_with_online_tune_and_trace_on_the_cpu(tmp_path):
    r = serve_mod.serve("olmo-1b", smoke=True, requests=3, max_new=4,
                        backend="tuned", device="cpu", online_tune=True,
                        trace=tmp_path / "t.json")
    assert r["tokens"] == 12 and r["cycles"] >= 0 and r["swaps"] >= 0
    assert not r["tuner"].running and r["tuner"].mode == "cpu"
    assert sum(r["steps_by_gen"].values()) >= r["decode_steps"]
    doc = json.loads(r["trace"].read_text())
    assert {e["args"]["name"] for e in doc["traceEvents"]
            if e["ph"] == "M" and e["name"] == "thread_name"} >= {
        "queue", "slot 0", "online tuner"}


# -- the timer and the tickets ------------------------------------------------

def test_timer_records_and_closes_on_the_callers_stream(monkeypatch):
    """``measure`` on the card: both events on the caller's current
    stream, each repeat closed by waiting on its end event, and never a
    device-wide ``torch.cuda.synchronize()``."""
    stream = object()
    log = []

    class FakeEvent:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.name = "e0" if not any(
                x[0] == "new" for x in log) else "e1"
            log.append(("new", self.name))

        def record(self, s=None):
            log.append(("record", self.name, s))

        def synchronize(self):
            log.append(("sync", self.name))

        def elapsed_time(self, other):
            return 0.25

    def no_device_sync(*a, **kw):
        raise AssertionError("device-wide synchronize")
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", no_device_sync)
    calls = []
    m = timer.measure(lambda: calls.append(1), device="cuda", warmup=2,
                      reps=3)
    assert len(calls) == 5 and m.median_us == 250.0 and m.reps == 3
    body = [x for x in log if x[0] != "new"]
    assert body == [("record", "e0", stream), ("record", "e1", stream),
                    ("sync", "e1")] * 3


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def test_split_tickets_are_kept_per_stream(monkeypatch):
    """Split launches on two streams (stand-in stream keys on CPU
    tensors, the C library stubbed) get two ticket arrays; launches on
    one stream share one, for the IAAT and the grouped kernel alike."""
    from repro_torch.kernels import build
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)
    monkeypatch.setattr(iaat_gemm, "_tickets", {})
    streams = [7]
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda idx: streams[0], raising=False)
    cpu = torch.device("cpu")
    assert iaat_gemm._tickets_on(cpu, 1) is iaat_gemm._tickets_on(cpu, 1)
    assert iaat_gemm._tickets_on(cpu, 1) is not iaat_gemm._tickets_on(cpu, 2)
    iaat_gemm._entry.cache_clear()
    bf = torch.bfloat16
    x, w = torch.zeros((4, 2048), dtype=bf), torch.zeros((2048, 1000),
                                                         dtype=bf)
    sig = KernelSig("H", "NN", 16, 256, 64)
    gx, gw = torch.zeros((2, 8, 2048), dtype=bf), \
        torch.zeros((2, 2048, 200), dtype=bf)
    tickets = {}
    try:
        for s in (7, 9, 7):
            streams[0] = s
            iaat_gemm._launch(sig, x, w, None, 1.0, 0.0, None, 16)
            t_iaat = lib.calls[-1][1][22]
            gg._launch_batched(gx, gw, (16, 64, 64), slices=3)
            t_grouped = lib.calls[-1][1][21]
            assert lib.calls[-1][1][-1] == s
            assert t_iaat == t_grouped            # one array a stream
            assert tickets.setdefault(s, t_iaat) == t_iaat
    finally:
        iaat_gemm._entry.cache_clear()
        iaat_gemm.reset_launch_count()
        gg.reset_launch_count()
    assert tickets[7] != tickets[9]
    assert set(iaat_gemm._tickets) >= {(cpu, 7), (cpu, 9)}


# -- timings worth installing on the card --------------------------------------

def test_card_timings_take_a_warm_up_and_three_repeats(monkeypatch):
    """On the card the tuner passes at least one warm-up and three repeats
    to the sweep (the launcher's reps=1 included); on the CPU what it was
    given (the stream and the sweep stubbed, so that it runs without a
    card)."""
    seen = []

    class FakeStream:
        def __init__(self, device):
            pass

    class FakeContext:
        def __init__(self, s):
            pass

        def __enter__(self):
            pass

        def __exit__(self, *exc):
            pass

    def fake_sweep(targets, **kw):
        seen.append((kw["device"].type, kw["warmup"], kw["reps"]))
        return _here(), [], 0
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "stream", FakeContext)
    monkeypatch.setattr(search, "budgeted_sweep", fake_sweep)
    t = [TuneTarget("gemm", SizeClass("S", "NN", 5, 5, 5), 3.0)]
    for device, warmup, reps in (("cuda", 0, 1), ("cuda", 2, 7),
                                 ("cpu", 0, 1)):
        tn = OnlineTuner(device=device, warmup=warmup, reps=reps)
        tn._sweep(t)
    assert seen == [("cuda", 1, 3), ("cuda", 2, 7), ("cpu", 0, 1)]


def test_card_operands_are_drawn_on_the_card(monkeypatch):
    """On the card the operands come from a seeded generator on the card,
    drawn there in the letter's plane type (stubbed, so that it runs
    without a card); on the CPU from the host generator, in f64, as
    before."""
    gens, draws = [], []

    class FakeGenerator:
        def __init__(self, device="cpu"):
            self.device = torch.device(device)
            gens.append(self)

        def manual_seed(self, seed):
            self.seed = seed
            return self

    def fake_randn(shape, generator=None, dtype=None, device=None):
        draws.append((generator.device.type, dtype,
                      torch.device(device).type))
        return torch.zeros(shape, dtype=dtype)
    monkeypatch.setattr(torch, "Generator", FakeGenerator)
    monkeypatch.setattr(torch, "randn", fake_randn)
    for letter in ("H", "S", "D", "Z"):
        search._maker(letter, "cuda")((4, 4))
    assert all(g.device.type == "cuda" and g.seed == search.SEED
               for g in gens)
    assert draws == [("cuda", torch.float32, "cuda"),
                     ("cuda", torch.float32, "cuda"),
                     ("cuda", torch.float64, "cuda"),
                     ("cuda", torch.float64, "cuda"),
                     ("cuda", torch.float64, "cuda")]


def test_cpu_operands_stay_deterministic():
    a = search._maker("S", "cpu")((3, 5))
    b = search._maker("S", "cpu")((3, 5))
    assert a.device.type == "cpu" and torch.equal(a, b)
    want = torch.randn((3, 5), generator=torch.Generator().manual_seed(
        search.SEED), dtype=torch.float64).float()
    assert torch.equal(a, want)


def test_card_sweep_primes_the_library_before_timing(monkeypatch):
    """On the card the sweep first calls the library once per harness and
    letter of its targets, before any timing (stubbed, so that it runs
    without a card)."""
    order = []
    monkeypatch.setattr(search, "_new_profile",
                        lambda device, kind: _here())
    monkeypatch.setattr(search, "_prime_library",
                        lambda targets, device: order.append(
                            ("prime", len(targets))))

    def fake_tune(sc, **kw):
        order.append(("time", sc.key))
        return _entry(1.0, 2.0)
    monkeypatch.setattr(search, "tune_class", fake_tune)
    t = [TuneTarget("gemm", SizeClass("H", "NN", 2, 12, 11), 3.0)]
    search.budgeted_sweep(t, budget=8, device="cuda")
    search.budgeted_sweep(t, budget=8, device="cpu")
    assert order == [("prime", 1), ("time", "H/NN/2-12-11"),
                     ("time", "H/NN/2-12-11")]


# -- polled cycles: the tuner on the engine's thread ---------------------------

def test_poll_cycles_once_the_interval_has_passed(monkeypatch):
    """The first poll starts the clock, a poll before ``interval_s`` does
    nothing, one after it cycles on the caller's thread; nothing under the
    kill switch or while the background loop runs."""
    _route_traffic()
    clock = [100.0]
    monkeypatch.setattr(online.time, "perf_counter", lambda: clock[0])
    tn = OnlineTuner(sweeper=_stub_sweeper(), interval_s=0.5)
    assert tn.poll() is None and tn.cycles == 0
    clock[0] += 0.4
    assert tn.poll() is None and tn.cycles == 0
    clock[0] += 0.1
    rep = tn.poll()
    assert rep is not None and rep.cycle == 1 and rep.swapped
    assert tn.poll() is None                      # the clock restarted
    clock[0] += 0.5
    monkeypatch.setenv(online.KILL_SWITCH_ENV, "0")
    assert tn.poll() is None and tn.cycles == 1
    monkeypatch.delenv(online.KILL_SWITCH_ENV)
    monkeypatch.setattr(OnlineTuner, "running", property(lambda self: True))
    assert tn.poll() is None and tn.cycles == 1
    monkeypatch.setattr(OnlineTuner, "running", property(lambda self: False))
    assert tn.poll().cycle == 2


def test_poll_counts_errors_and_never_raises(monkeypatch):
    _route_traffic()

    def broken(targets, *, budget):
        raise RuntimeError("the stopwatch broke")
    tn = OnlineTuner(sweeper=broken, interval_s=0.0)
    assert [tn.poll() for _ in range(3)] == [None] * 3
    assert obs.counter("tune.online.errors").value == 3
    assert profile_mod.active_profile() is None


def test_engine_cycles_its_tuner_between_steps(smoke_f32):
    """A real tuner on the engine: its cycles run between steps (none
    inside one) and publish at once, and the tokens equal a run with no
    tuner."""
    cfg, model, params = smoke_f32
    ref = _engine(model, params)
    ref.submit(Request(0, np.arange(3), max_new=4))
    want = ref.run()
    tuner = OnlineTuner(device="cpu", interval_s=0.0,
                        sweeper=_stub_sweeper())
    e = _engine(model, params, tuner)
    inside = []
    real_step = e._step

    def step():
        inside.append(True)
        try:
            return real_step()
        finally:
            inside.pop()
    e._step = step
    cycle = tuner.cycle

    def counted():
        assert not inside
        return cycle()
    tuner.cycle = counted
    e.submit(Request(0, np.arange(3), max_new=4))
    assert e.run() == want
    assert tuner.cycles >= 1 and tuner.swaps >= 1 and not tuner.running
    assert len(e.steps_by_gen) >= 2
