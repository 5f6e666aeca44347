"""The harness is driven by data: BENCHMARK.json against the contract's
shape, every cell's files found by name, a cell added as new files and a
new entry picked up, the generator's determinism and bounds, and no
result without a card."""
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from perfbench import gen, serve, spec
from conftest import small_chat, smoke

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_benchmark_json_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_finds_its_files_and_metrics(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        doc = spec.config(bench, w["config"])
        mix = spec.traffic(w["traffic"])
        assert mix["kind"] in ("serve", "train")
        assert spec.limits(w["name"])
        assert doc["name"] == w["config"]
        # the family's hooks and the plain reference, found by name
        assert spec.family(doc["family"]).__file__ == \
            str(BENCH / "families" / f"{doc['family']}.py")
        assert (BENCH / "reference" / f"{doc['reference']}.py").is_file()
        reported = {m["name"] for m in spec.metrics_of(bench, "end_to_end",
                                                       w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = spec.metrics_of(bench, "per_layer", w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in e2e and m["moves"] in reported
            assert callable(spec.reader(m["name"]))


def test_reduced_keys_are_in_the_file(bench):
    for c in bench["configs"]:
        doc = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("perfbench/")
        for k in c["reduced"]:
            assert k in doc and k in doc["published"]
            assert doc[k] != doc["published"][k]


def test_chat_is_deterministic_and_within_bounds():
    mix = spec.traffic("chat-32")
    a = gen.ServeTraffic(mix, 2 ** 31 + 7, 50304)
    b = gen.ServeTraffic(mix, 2 ** 31 + 7, 50304)
    c = gen.ServeTraffic(mix, 11, 50304)
    for j in (0, 1, 500, 5000):
        pa, na = a.request(j)
        pb, nb = b.request(j)
        assert np.array_equal(pa, pb) and na == nb
        assert 1 <= len(pa) <= 768 and 1 <= na <= 384
        assert pa.min() >= 0 and pa.max() < 50304
        assert len(pa) + na <= mix["max_len"]
    # another seed: the same set of sizes in another order
    assert sorted(a.prompt_len) == sorted(c.prompt_len)
    assert sorted(a.output_len) == sorted(c.output_len)
    assert list(a.prompt_len) != list(c.prompt_len)
    # the source's means (69.5 and 214.5 tokens) as 16 mid-quantiles;
    # outputs cut at 384
    assert float(np.mean(a.prompt_len)) == pytest.approx(62.0)
    assert float(np.mean(a.output_len)) == pytest.approx(179.125)
    assert list(np.sort(a.output_len)[-3:]) == [353, 384, 384]


def test_lognormal_quantiles_keep_the_stated_mean():
    """Uncut and with many quantiles, the pool's mean and sd come to
    what the mix states."""
    q = gen._quantiles({"dist": "lognormal", "mean": 214.5, "sd": 226.3,
                        "lo": 1, "hi": 10 ** 9}, 4096)
    assert float(q.mean()) == pytest.approx(214.5, rel=0.01)
    assert float(q.std()) == pytest.approx(226.3, rel=0.05)


def test_train_batches_differ_by_step():
    mix = spec.traffic("train-8x2048")
    x0 = gen.train_batch(mix, 5, 0, 50304, "cpu")
    x1 = gen.train_batch(mix, 5, 1, 50304, "cpu")
    assert x0.shape == (8, 2048) and not bool((x0 == x1).all())
    assert bool((x0 == gen.train_batch(mix, 5, 0, 50304, "cpu")).all())
    assert len({tuple(r.tolist()) for r in x0}) == 8


def test_a_cell_added_as_files_is_picked_up(tmp_path, bench):
    """A new mix, limits and per-layer reader, as files, and new entries:
    the harness runs the cell and reads the metric without an edit."""
    here = tmp_path / "perfbench"
    for d in ("traffic", "limits", "metrics"):
        (here / d).mkdir(parents=True)
    mix = small_chat(clients=2, slots=2)
    (here / "traffic" / "chat-open.json").write_text(json.dumps(mix))
    (here / "limits" / "olmo-1b.chat-open.json").write_text(
        json.dumps({"max_gap": 1.0}))
    (here / "metrics" / "steps.serve.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")
    b = json.loads(json.dumps(bench))
    b["workloads"].append({"name": "olmo-1b.chat-open", "config": "olmo-1b",
                           "traffic": "chat-open", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "steps.serve", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "engine", "moves": "serve_tok_s",
                           "workloads": ["olmo-1b.chat-open"]})
    m = spec.traffic("chat-open", here=here)
    lim = spec.limits("olmo-1b.chat-open", here=here)
    res = serve.run(smoke("olmo-1b"), m, lim, 3, 1.0, False, device="cpu")
    assert res["attempted"] > 0 and res["failed"] == 0
    read = spec.reader("steps.serve", here=here)
    assert read(res["ctx"]) == res["ctx"]["steps"] > 0
    assert [x["name"] for x in spec.metrics_of(b, "per_layer",
                                               "olmo-1b.chat-open")] == \
        ["steps.serve"]


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the command exits non-zero and prints no
    result line; it never falls back to the CPU."""
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "olmo-1b.chat-32", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES":
                            "", "HOME": str(tmp_path)})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and perfbench/, the
    command exits non-zero with no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "olmo-1b.chat-32", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_result_line_keys_and_checks_last(bench, monkeypatch):
    """The line holds the keys the contract names, the numbers compared
    come last, and a number that could not be read prints as null (the
    line stays valid JSON)."""
    import torch
    from perfbench import harness
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    cell = spec.cell(bench, "olmo-1b.chat-32")
    res = {"correct": False, "attempted": 3, "failed": 0,
           "e2e": {"serve_tok_s": 1.5}, "ctx": {}, "memory_peak_bytes": 7,
           "checks": [("max_gap", float("inf"), 0.12), ("failed", 0.0, 0.0)]}
    line = harness.result_line(bench, cell, res, False, 2.0)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"serve_tok_s", "setup_s"}
    assert line["device"] == {"platform": "gpu", "kind": "card", "count": 1,
                              "memory_peak_bytes": 7}
    assert line["checks"]["max_gap"] == {"value": None, "limit": 0.12}
    json.loads(json.dumps(line, allow_nan=False))
