"""A configuration's family is a file found by name
(``perfbench/families/<family>.py``).  The dense family gives the
weights and parameter tree it gave before it moved there, to the bit; a
family with no file, or without a hook, is refused by name; a family
added as files, with a configuration, a mix, limits and new entries in
a copy of ``BENCHMARK.json``, serves and trains through the harness
unedited; and drawing a layer's weights loads nothing of the program."""
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import program, spec, weights
from conftest import load, small_chat, small_train, smoke

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SEED = 2 ** 31 + 17


def digest(tensors):
    """sha256 over each tensor's name, shape, dtype and bytes, by name."""
    h = hashlib.sha256()
    for k in sorted(tensors):
        t = tensors[k].contiguous()
        h.update(k.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        raw = t.view(torch.uint8) if t.dtype == torch.bfloat16 else t
        h.update(raw.numpy().tobytes())
    return h.hexdigest()


# the smoke-size olmo-1b's draws at SEED on the CPU, as weights.py gave
# them before the draw moved into families/dense.py
PINNED = {
    ("layer", "bfloat16", "tied"):
        "888cfbcadd11f20aacdfb993498e271e1dd360491959c6bc5a2f339a7c8ce674",
    ("outer", "bfloat16", "tied"):
        "d700f4eff1e9f12ffa10a4488aa671bb665e8401d8dcbcf3edf50e374549aa87",
    ("layer", "float32", "tied"):
        "11f033316e7b2e5a56f52f55fe868fcb76297cc605f027fe8070973cedba60f3",
    ("outer", "float32", "tied"):
        "57552e7fb7ce4427c6ff574240e2aa77cebb7ed11f9b55ba96cff7b97a12c839",
    ("layer", "float32", "untied"):
        "5cd8086207e881d1ab5efb63e73062683e7b5a09e9fa742852d8e5493145d42a",
    ("outer", "float32", "untied"):
        "043ae4c20431c3658e8109e1f096cb1db6d40ae6de7570b16a7efe8daa34813c",
}

_LAYER = {"attn.wq": [64, 64], "attn.wk": [64, 64], "attn.wv": [64, 64],
          "attn.wo": [64, 64], "mlp.wg": [64, 128], "mlp.wu": [64, 128],
          "mlp.wd": [128, 64]}


def _doc(kind):
    """olmo-1b at smoke size; ``untied``: a norm weight and its own head."""
    if kind == "tied":
        return smoke("olmo-1b")
    return smoke("olmo-1b", parametric_norm=True, tie_embeddings=False)


@pytest.mark.parametrize("via", ["weights", "family"])
@pytest.mark.parametrize("what,dtype,kind", sorted(PINNED))
def test_dense_draw_is_pinned(via, what, dtype, kind):
    """Layer 1 (layer 0 untied) and the outer weights, through
    ``weights``' names and through the family file."""
    src = weights if via == "weights" else spec.family("dense")
    dt = getattr(torch, dtype)
    doc = _doc(kind)
    got = src.layer(doc, SEED, 1 if kind == "tied" else 0, dt, "cpu") \
        if what == "layer" else src.outer(doc, SEED, dt, "cpu")
    assert digest(got) == PINNED[(what, dtype, kind)]


@pytest.mark.parametrize("via", ["program", "family"])
@pytest.mark.parametrize("kind", ["tied", "untied"])
def test_dense_parameter_tree_is_pinned(via, kind):
    """The port's ``DenseLM`` has the names and shapes it had, in order,
    and holds the seeded draw."""
    src = program if via == "program" else spec.family("dense")
    doc = _doc(kind)
    params = src.port_params(doc, SEED, torch.float32, "cpu")
    got = [(k, list(v.shape)) for k, v in params.named_parameters()]
    if kind == "tied":
        want = [("embed", [256, 64])] + [
            (f"blocks.{i}.{k}", s) for i in range(2) for k, s in
            _LAYER.items()]
    else:
        want = [("embed", [256, 64]), ("final_norm", [64]),
                ("unembed", [64, 256])] + [
            (f"blocks.{i}.{k}", s) for i in range(2) for k, s in
            [("ln1", [64]), ("ln2", [64])] + list(_LAYER.items())]
    assert got == want
    named = dict(params.named_parameters())
    layer1 = weights.layer(doc, SEED, 1, torch.float32, "cpu")
    assert all(torch.equal(named[f"blocks.1.{k}"], v)
               for k, v in layer1.items())
    cfg = src.port_config(doc)
    assert (cfg.family, cfg.n_layers, cfg.vocab_padded) == ("dense", 2, 256)


def test_a_family_without_a_file_is_named(tmp_path):
    with pytest.raises(FileNotFoundError,
                       match=r"'sparse'.*families/sparse\.py"):
        spec.family("sparse", here=tmp_path)


def test_a_family_without_a_hook_is_refused(tmp_path):
    (tmp_path / "families").mkdir()
    (tmp_path / "families" / "half.py").write_text(
        "def port_config(doc):\n    return None\n")
    with pytest.raises(AttributeError, match="'half'.*port_params"):
        spec.family("half", here=tmp_path)


WRAPPED = '''"""A family that serves through the dense family's hooks and records
each hook it served."""
from perfbench import spec

DENSE = spec.family("dense")
SERVED = set()


def _hook(name):
    def hook(doc, *a, **k):
        SERVED.add(name)
        return getattr(DENSE, name)(doc, *a, **k)
    return hook


def port_config(doc):
    SERVED.add("port_config")
    return DENSE.port_config(dict(doc, family="dense"))


for _name in spec.FAMILY_HOOKS[1:]:
    globals()[_name] = _hook(_name)
'''

DRIVE = '''import json, sys
from perfbench import serve, spec, train
from perfbench.work import counts
bench = spec.load_benchmark()
out = {"perfbench": spec.HERE.as_posix()}
for name in ("olmo-wrapped.chat-small", "olmo-wrapped.train-small"):
    cell = spec.cell(bench, name)
    doc = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    kind = serve if mix["kind"] == "serve" else train
    res = kind.run(doc, mix, spec.limits(name), int(sys.argv[1]), 1.0,
                   False, device="cpu")
    out[name] = {"correct": res["correct"], "failed": res["failed"],
                 "attempted": res["attempted"], "checks": res["checks"]}
counts.tokens_flops(doc, [0, 1])
counts.pass_gemms(doc, 4)
counts.train_step_gemms(doc, 2, 32)
out["served"] = sorted(spec.family(doc["family"]).SERVED)
print(json.dumps(out))
'''


def test_a_family_added_as_files_is_picked_up(tmp_path):
    """A checkout whose ``perfbench/`` gains only new files (a family that
    wraps dense, a configuration of it, two mixes and their limits) and
    whose ``BENCHMARK.json`` gains only new entries: serving and training
    run through every hook of the new family and read ``correct``."""
    top = tmp_path / "checkout"
    shutil.copytree(BENCH, top / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = top / "perfbench"
    (here / "families" / "wrapped.py").write_text(WRAPPED)
    # f32: at smoke widths bf16's rounding alone reads past the cells'
    # limits, which are set for their full widths
    doc = dict(smoke("olmo-1b", family="wrapped", dtype="float32"),
               name="olmo-wrapped")
    (here / "configs" / "olmo-wrapped.json").write_text(json.dumps(doc))
    (here / "traffic" / "chat-small.json").write_text(
        json.dumps(small_chat(clients=2, slots=2)))
    (here / "traffic" / "train-small.json").write_text(
        json.dumps(small_train()))
    for cell, of in (("chat-small", "olmo-1b.chat-32"),
                     ("train-small", "olmo-1b.train-8x2048")):
        (here / "limits" / f"olmo-wrapped.{cell}.json").write_text(
            json.dumps(load("limits", of)))
    bench = spec.load_benchmark()
    bench["configs"].append({"name": "olmo-wrapped", "source": "x",
                             "file": "perfbench/configs/olmo-wrapped.json",
                             "reduced": [], "why": "x"})
    for cell in ("chat-small", "train-small"):
        bench["workloads"].append({"name": f"olmo-wrapped.{cell}",
                                   "config": "olmo-wrapped",
                                   "traffic": cell, "chips": 1, "why": "x"})
    (top / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(top), str(ROOT / "src")]), OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", DRIVE, str(SEED)], cwd=top,
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["perfbench"] == here.resolve().as_posix()
    for cell in ("chat-small", "train-small"):
        res = out[f"olmo-wrapped.{cell}"]
        assert res["correct"] and res["failed"] == 0, res
        assert res["attempted"] > 0
    assert out["served"] == sorted(spec.FAMILY_HOOKS)


def test_drawing_weights_loads_nothing_of_the_program():
    """The plain reference draws its weights through the family file, so
    loading it and drawing a layer import no module of ``repro_torch``."""
    code = ("import json, sys, torch\n"
            "from perfbench import weights\n"
            f"doc = json.loads({json.dumps(json.dumps(smoke('olmo-1b')))})\n"
            "weights.layer(doc, 1, 0, torch.float32, 'cpu')\n"
            "weights.outer(doc, 1, torch.float32, 'cpu')\n"
            "print(json.dumps(sorted({m.split('.')[0]\n"
            "                         for m in sys.modules})))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    tops = json.loads(p.stdout.strip().splitlines()[-1])
    assert "perfbench" in tops and "torch" in tops
    assert "repro_torch" not in tops and "repro" not in tops
