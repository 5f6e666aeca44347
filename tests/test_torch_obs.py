"""The port's observability export against the JAX package's: the
registry's JSON, BENCH export / load / diff, the Router's windowed shape
feed, and ``python -m repro_torch.obs``.

Both packages get the same operations in the same order (the same metric
updates, the same routed shapes, the same injected clock) and must give
the same documents."""
import json
import pathlib
import random

import pytest

from repro import api as japi, obs as jobs
from repro_torch import api, obs
from repro_torch.obs import __main__ as obs_cli

ROOT = pathlib.Path(__file__).resolve().parents[1]


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


def test_bench_export_load_and_diff_rows_equal_the_reference(tmp_path):
    """Each package exports its registry; loaded back, both packages'
    ``diff_bench`` give the same rows on the same documents."""
    docs = {}
    for name, o, seed in (("port", obs, 0), ("ref", jobs, 0),
                          ("port2", obs, 3)):
        o.reset()
        _feed_metrics(o, seed)
        p = o.export_bench(name, {"arch": "olmo-smoke"}, root=tmp_path)
        assert p == tmp_path / f"BENCH_{name}.json"
        docs[name] = o.load_bench(p)
    assert docs["port"]["metrics"] == docs["ref"]["metrics"]
    assert docs["port"]["schema"] == jobs.BENCH_SCHEMA_VERSION == \
        obs.BENCH_SCHEMA_VERSION
    for a, b in (("port", "port2"), ("ref", "port2"), ("port2", "ref")):
        rows = obs.diff_bench(docs[a], docs[b])
        assert rows == jobs.diff_bench(docs[a], docs[b])
        assert rows
    assert obs._scalar_metrics(docs["port"]) == \
        jobs._scalar_metrics(docs["ref"])
    # one-sided keys and a zero base give None, as in the reference
    only = {"schema": 1, "metrics": {"x": {"type": "counter", "value": 0}}}
    assert obs.diff_bench(only, {"schema": 1, "metrics": {}}) == \
        jobs.diff_bench(only, {"schema": 1, "metrics": {}}) == \
        [("x", 0.0, None, None)]
    bad = tmp_path / "BENCH_bad.json"
    bad.write_text(json.dumps({"schema": 99}))
    with pytest.raises(ValueError, match="schema"):
        obs.load_bench(bad)


def test_router_snapshot_rows(tmp_path):
    r = api.Router(api.Policy(backend="auto"))
    for _ in range(3):
        r.route("gemm", (45, 45, 45), "S")
    r.route("gemm", (3000, 3000, 3000), "S")
    rows = obs.ROUTES.snapshot()
    assert rows[0] == {"op": "gemm", "dtype": "S", "trans": "NN",
                       "size_class": "5-5-5", "use_kernel": True,
                       "source": "analytical", "count": 3}
    assert rows[1]["use_kernel"] is False and rows[1]["count"] == 1
    doc = obs.load_bench(obs.export_bench("r", root=tmp_path))
    assert doc["router"] == rows
    assert "router shape histogram (4 decisions)" in obs.report_str()


def test_trajectory_is_kept_across_exports(tmp_path):
    obs.counter("t.x").inc()
    obs.record_trajectory("traj", {"tok_s": 1.5}, root=tmp_path)
    obs.record_trajectory("traj", {"tok_s": 2.5}, root=tmp_path)
    p = obs.export_bench("traj", root=tmp_path)
    doc = obs.load_bench(p)
    assert [r["tok_s"] for r in doc["trajectory"]] == [1.5, 2.5]
    assert doc["metrics"]["t.x"]["value"] == 1
    assert all(r["recorded_unix"] > 0 for r in doc["trajectory"])


def test_bench_root_is_never_the_repository_root(tmp_path, monkeypatch):
    """The default lands under build/repro_torch/bench/ in the checkout,
    which .gitignore lists; the environment variable moves it; nothing
    is written at the root, which holds the reference's BENCH files."""
    monkeypatch.delenv(obs.BENCH_DIR_ENV, raising=False)
    root = obs.bench_root()
    assert root == ROOT / "build" / "repro_torch" / "bench"
    assert root.resolve() != ROOT.resolve()
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    before = sorted(ROOT.glob("BENCH_*.json"))
    monkeypatch.setenv(obs.BENCH_DIR_ENV, str(tmp_path / "bench"))
    assert obs.bench_root() == tmp_path / "bench"
    p = obs.export_bench("where")
    assert p == tmp_path / "bench" / "BENCH_where.json" and p.exists()
    obs.record_trajectory("where", {"n": 1})
    assert sorted(ROOT.glob("BENCH_*.json")) == before


def test_cli_ls_show_diff_and_report(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(obs.BENCH_DIR_ENV, str(tmp_path))
    assert obs_cli.main(["ls"]) == 0
    assert "no BENCH_*.json under" in capsys.readouterr().out
    _feed_metrics(obs)
    api.Router(api.Policy(backend="auto")).route("gemm", (45, 45, 45), "S")
    a = obs.export_bench("a", {"run": 1})
    obs.counter("serve.requests").inc(7)
    b = obs.export_bench("b")
    for cmd in ([], ["list"], ["ls"]):
        assert obs_cli.main(cmd) == 0
        out = capsys.readouterr().out
        assert "BENCH_a.json" in out and "BENCH_b.json" in out
    assert obs_cli.main(["show", str(a)]) == 0
    out = capsys.readouterr().out
    assert "meta: run=1" in out and "serve.ttft_us.p50" in out
    assert "router shape histogram (1 classes)" in out
    assert obs_cli.main(["diff", str(a), str(b)]) == 0
    out = capsys.readouterr().out
    assert "serve.requests" in out and "+100.0%" in out
    assert obs_cli.main(["report"]) == 0
    assert "== repro_torch.obs report ==" in capsys.readouterr().out
    for bad in (["show"], ["diff", str(a)], ["trace"],
                ["trace", "a", "b", "c"]):
        with pytest.raises(SystemExit) as e:
            obs_cli.main(bad)
        assert e.value.code != 0
