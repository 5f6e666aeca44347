"""The port's observability against the JAX package's: the registry's
JSON and the Router's windowed shape feed; and ``python -m
repro_torch.obs``.

Both packages get the same operations in the same order (the same metric
updates, the same routed shapes, the same injected clock) and must give
the same documents."""
import random

import pytest

from repro import api as japi, obs as jobs
from repro_torch import api, obs
from repro_torch.obs import __main__ as obs_cli


@pytest.fixture(autouse=True)
def _clean_obs():
    for o in (obs, jobs):
        o.set_enabled(True)
        o.reset()
    yield
    for o in (obs, jobs):
        o.set_enabled(True)
        o.reset()


def _feed_metrics(o, seed=0):
    """The same counter, gauge and histogram updates in either package."""
    rng = random.Random(seed)
    o.counter("serve.requests").inc(7)
    o.counter("t.events", op="gemm").inc()
    o.counter("t.events", op="matmul").inc(3)
    o.gauge("serve.blocks_in_use").set(12.5)
    h = o.histogram("serve.ttft_us")
    for _ in range(200):
        h.record(rng.lognormvariate(8.0, 1.5))
    h.record(0.0)
    o.histogram("serve.empty_us")


def test_registry_snapshot_equals_the_reference():
    _feed_metrics(obs)
    _feed_metrics(jobs)
    assert obs.REGISTRY.snapshot() == jobs.REGISTRY.snapshot()
    assert list(obs.REGISTRY.collect("t.")) == \
        list(jobs.REGISTRY.collect("t."))
    snap = obs.REGISTRY.snapshot()
    assert snap["serve.requests"] == {"type": "counter", "value": 7}
    assert snap["serve.empty_us"]["count"] == 0
    assert obs._NULL.to_json() == jobs._NULL.to_json() == {"type": "null"}


def test_set_enabled_flips_every_collector():
    obs.set_enabled(False)
    try:
        assert not obs.enabled()
        assert not obs.ROUTES.on and not obs.TRACE.on
        assert obs.counter("t.off") is obs._NULL
        api.Router(api.Policy(backend="auto")).route("gemm", (8, 8, 8), "S")
        assert obs.ROUTES.total == 0
    finally:
        obs.set_enabled(True)
    assert obs.enabled() and obs.ROUTES.on and obs.TRACE.on


def _route_same(n_calls=60, seed=1):
    """The same routed shapes through both packages' Routers."""
    rng = random.Random(seed)
    tr, jr = api.Router(api.Policy(backend="auto")), \
        japi.Router(japi.Policy(backend="auto"))
    for _ in range(n_calls):
        op = rng.choice(("gemm", "matmul", "batched_gemm", "ragged_gemm"))
        letter = rng.choice("SDH")
        if op == "gemm":
            dims = tuple(rng.randint(1, 300) for _ in range(3))
        elif op == "matmul":
            dims = (rng.randint(1, 4), rng.randint(1, 40),
                    rng.randint(8, 300), rng.randint(8, 300))
        else:
            dims = (rng.randint(1, 8), rng.choice((8, 16, 128)),
                    rng.randint(8, 300), rng.randint(8, 300))
        for r in (tr, jr):
            r.route(op, dims, letter, "NN")


def test_shape_counts_and_windowed_equal_the_reference():
    """Buckets closed at observation time by an injected clock: the same
    routes between the same polls give equal buckets, and equal decayed
    weights within 1e-12."""
    polls = (100.0, 100.4, 101.2, 101.9, 103.5, 103.6, 106.0)
    for i, now in enumerate(polls):
        _route_same(seed=i)
        assert obs.ROUTES.shape_counts() == jobs.ROUTES.shape_counts()
        got = obs.ROUTES.windowed(4, bucket_s=1.0, now=now)
        want = jobs.ROUTES.windowed(4, bucket_s=1.0, now=now)
        assert got == want
    for decay in (0.5, 0.9, 1.0):
        got = obs.ROUTES.windowed(8, bucket_s=1.0, decay=decay, now=106.5)
        want = jobs.ROUTES.windowed(8, bucket_s=1.0, decay=decay,
                                    now=106.5)
        assert got.keys() == want.keys() and got
        for k in got:
            assert abs(got[k] - want[k]) <= 1e-12
    assert len(obs.ROUTES.windowed(2, now=107.0)) == 2
    with pytest.raises(ValueError):
        obs.ROUTES.windowed(0)
    with pytest.raises(ValueError):
        obs.ROUTES.windowed(2, decay=1.5)


def test_windowed_counts_survive_a_profile_invalidation():
    """A profile swap folds the memo into the aggregate: the window's
    counts keep every call made before it."""
    r = api.Router(api.Policy(backend="auto"))
    obs.ROUTES.windowed(now=0.0)
    for _ in range(3):
        r.route("gemm", (45, 45, 45), "S")
    obs.ROUTES.invalidate()
    r.route("gemm", (45, 45, 45), "S")
    assert obs.ROUTES.windowed(now=0.5) == [{("gemm", "S", "5-5-5"): 4}]
    obs.ROUTES.reset()
    assert obs.ROUTES.windowed(4, now=10.0) == [{}]


def test_router_snapshot_rows():
    r = api.Router(api.Policy(backend="auto"))
    for _ in range(3):
        r.route("gemm", (45, 45, 45), "S")
    r.route("gemm", (3000, 3000, 3000), "S")
    rows = obs.ROUTES.snapshot()
    assert rows[0] == {"op": "gemm", "dtype": "S", "trans": "NN",
                       "size_class": "5-5-5", "use_kernel": True,
                       "source": "analytical", "count": 3}
    assert rows[1]["use_kernel"] is False and rows[1]["count"] == 1
    assert "router shape histogram (4 decisions)" in obs.report_str()


def test_cli_ls_show_diff_and_report(capsys):
    """The CLI prints the live registry (``report``, the default) and
    re-exports traces; the BENCH file commands ``ls``, ``show`` and
    ``diff`` are gone, and bad arguments exit non-zero."""
    _feed_metrics(obs)
    api.Router(api.Policy(backend="auto")).route("gemm", (45, 45, 45), "S")
    for cmd in ([], ["report"]):
        assert obs_cli.main(cmd) == 0
        out = capsys.readouterr().out
        assert "== repro_torch.obs report ==" in out
        assert "serve.requests" in out
        assert "router shape histogram (1 decisions)" in out
    for bad in (["ls"], ["list"], ["show", "BENCH_a.json"],
                ["diff", "BENCH_a.json", "BENCH_b.json"], ["report", "x"],
                ["trace"], ["trace", "a", "b", "c"]):
        with pytest.raises(SystemExit) as e:
            obs_cli.main(bad)
        assert e.value.code != 0
