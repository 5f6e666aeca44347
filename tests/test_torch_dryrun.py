"""The dry run (``launch/dryrun.py``), its per-aten-op counter
(``launch/step_analyzer.py``) and roofline (``launch/step_stats.py``).

The counter's matmul FLOPs are held to the count worked out from a smoke
config's shapes, and to the same counter around the same step on real
CPU tensors; remat ``full`` must add exactly the blocks' forward FLOPs
(the recompute) and nothing of the embedding or the vocabulary head.  Two
full-size cells run on the meta device; the CLI writes its JSON and
skips what it has; nothing touches CUDA or leaves a process group.

A train cell on a mesh of several ranks is a real sharded step under a
fake process group of the mesh's size (``dryrun.fake_world``), counted
as rank 0's local ops: with no fallback its matmul FLOPs are the global
count / devices exactly, a rule's fallback adds the work it replicates,
and its collectives are counted by kind.  A serving cell runs on one
rank (the port serves on one rank) and keeps the ideal split.  The SSM
serving recurrence's token loop is trip-counted on the meta device: the
counts equal the unrolled loop's exactly.
"""
import dataclasses
import json

import pytest
import torch

from repro_torch import api, configs
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core import cost
from repro_torch.launch import dryrun, mesh as mesh_mod, step_stats
from repro_torch.launch.step_analyzer import StepCounter
from repro_torch.models import registry
from repro_torch.train import loop as TL

LIBRARY = api.named_policy("library")
ONE = mesh_mod.mesh_shape((1, 1), ("data", "model"))


def _smoke(arch="olmo-1b", **kw):
    return dataclasses.replace(configs.get_smoke(arch), **kw)


def _forward_flops(cfg, B, S):
    """olmo-smoke's forward matmul FLOPs from its shapes: per layer the
    q/k/v/o and gated-MLP projections and the attention oracle's two
    products over one KV chunk (S <= 1024 keys), then the vocab head."""
    T, d, hd, ff = B * S, cfg.d_model, cfg.head_dim_, cfg.d_ff
    H, Hkv = cfg.n_heads_padded, cfg.n_kv_heads_padded
    proj = 2 * T * d * (H * hd + 2 * Hkv * hd) + 2 * T * H * hd * d \
        + 3 * 2 * T * d * ff
    attn = 2 * (2 * B * H * S * S * hd)
    return cfg.n_layers * (proj + attn) + 2 * T * d * cfg.vocab_padded


def test_counter_flops_equal_the_count_from_shapes():
    cfg = _smoke()
    B, S = 2, 16
    model = registry.build(cfg)
    params = model.init(torch.Generator(), "meta")
    toks = torch.zeros(B, S, dtype=torch.int32, device="meta")
    with StepCounter() as c, torch.no_grad():
        model.forward_train(params, toks, LIBRARY)
    assert c.flops == _forward_flops(cfg, B, S)
    assert c.dots == cfg.n_layers * (4 + 3 + 2) + 1
    assert set(c.flops_by_op) == {"aten.mm", "aten.bmm"}
    assert c.bytes > 0 and c.ops > c.dots


def test_meta_count_equals_the_count_on_real_tensors():
    """One olmo-smoke train step under the library policy: the counter's
    FLOPs on the meta device equal its FLOPs around the same step on CPU
    tensors (the on-card anchor's check, here on the CPU), and the dry
    run's train-state bytes on the 1 x 1 mesh are the state's own."""
    cfg = _smoke()
    shape = ShapeConfig("t", 16, 2, "train")
    meta = dryrun.count_step(cfg, shape, ONE)
    model = registry.build(cfg)
    st = TL.init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 16), generator=g,
                              dtype=torch.int32) for k in ("tokens",
                                                           "labels")}
    with StepCounter() as real:
        TL.make_train_step(model, TL.TrainConfig(), LIBRARY)(st, batch)
    assert meta.flops == real.flops > 0
    assert meta.dots == real.dots
    args, _ = dryrun.argument_bytes(cfg, shape, ONE)
    own = sum(p.numel() * p.element_size()
              for m in (st["params"], st["opt"]["m"], st["opt"]["v"])
              for p in m.parameters())
    assert args["state"] == own + 4          # the step, an int32
    assert args["batch"] == 2 * 2 * 16 * 4


def _last_gemm_flops(cfg, T):
    """The FLOPs of each block's last matmul, summed over the blocks: the
    MLP's down projection (the MoE's combine, a bmm), a mamba layer's
    out_proj; the enc-dec's encoder and decoder layers alike (T frames)."""
    d = cfg.d_model
    if cfg.family == "moe":
        per = 2 * T * cfg.moe.top_k * d
    elif cfg.family in ("ssm", "hybrid"):
        per = 2 * T * cfg.d_inner * d
    else:
        per = 2 * T * cfg.d_ff * d
    return per * (cfg.n_layers + cfg.n_encoder_layers)


@pytest.mark.parametrize("arch", ["olmo-1b", "moonshot-v1-16b-a3b",
                                  "zamba2-7b", "seamless-m4t-large-v2"])
def test_full_remat_adds_the_blocks_forward(arch):
    """A train step's matmul FLOPs under ``full`` exceed those under
    ``none`` by the blocks' forward FLOPs (the encoder's too, the hybrid's
    shared block with the layer it precedes), recomputed in the backward
    pass, less each block's last matmul: the recompute stops once every
    tensor the backward saved is back (torch's early stop), and no
    backward reads that product's output (XLA drops it from the
    reference's rematerialised body as dead code).  The vocabulary head,
    like the embedding gather, is not recomputed."""
    shape = ShapeConfig("t", 16, 2, "train")
    got = {r: dryrun.count_step(_smoke(arch, remat=r), shape, ONE).flops
           for r in ("none", "full")}
    cfg = _smoke(arch)
    model = registry.build(cfg)
    params = model.init(torch.Generator(), "meta")
    toks = torch.zeros(2, 16, dtype=torch.int32, device="meta")
    extra = [torch.zeros(2, 16, cfg.d_model, device="meta")] \
        if cfg.frontend == "audio" else []
    with StepCounter() as fwd, torch.no_grad():
        model.forward_train(params, toks, LIBRARY, *extra)
    head = 2 * 2 * 16 * cfg.d_model * cfg.vocab_padded
    assert got["full"] - got["none"] == \
        fwd.flops - head - _last_gemm_flops(cfg, 2 * 16) > 0


@pytest.mark.parametrize("arch,shape,mesh", [
    ("olmo-1b", "decode_32k", False),
    ("moonshot-v1-16b-a3b", "decode_32k", True)])
def test_full_size_cells_on_meta(arch, shape, mesh):
    rec = dryrun.run_cell(arch, shape, mesh)
    assert rec["status"] == "ok"
    assert rec["devices"] == (512 if mesh else 256)
    ma = rec["memory_analysis"]
    assert ma["temp_size_in_bytes"] is None and ma["temp_note"]
    assert ma["argument_size_in_bytes"] == sum(ma["arguments"].values())
    assert set(ma["arguments"]) == {"params", "batch", "cache"}
    rl = rec["roofline"]
    # a serving cell runs on one rank: no collectives, the ideal split
    assert rl["collective_s"] is None and rl["coll_bytes"] is None
    assert rl["collective_note"] == step_stats.COLL_ONE_RANK
    assert rec["per_device"].startswith("ideal")
    assert rl["step_s"] == max(rl["compute_s"], rl["memory_s"]) > 0
    assert rl["flops"] == rec["analyzer"]["flops"] / rec["devices"]
    assert rec["model_flops_per_dev"] == dryrun.model_flops(
        configs.get_config(arch), SHAPES[shape]) / rec["devices"]
    json.dumps(rec)


def _train_cell(arch, mesh, batch, **kw):
    cfg = _smoke(arch, remat="none", **kw)
    shape = ShapeConfig("t", 32, batch, "train")
    ms = mesh_mod.mesh_shape(mesh, ("data", "model"))
    rec = dryrun.run_cell(arch, "t", False, accum=1, cfg=cfg, shape=shape,
                          mesh=ms)
    one = dryrun.count_step(cfg, shape, ONE)
    return rec, one, cfg


def test_train_cell_without_fallback_splits_every_dot():
    """olmo-smoke on 2 x 4 has no fallback: every dot is split both ways
    (batch over data, heads, mlp and vocab over model), so rank 0's
    matmul FLOPs are the one-rank step's / 8 exactly."""
    rec, one, _ = _train_cell("olmo-1b", (2, 4), 8)
    assert rec["rules_fallbacks"] == {}
    assert rec["per_device"].startswith("rank 0 of 8")
    assert rec["roofline"]["flops"] * 8 == one.flops > 0
    assert rec["analyzer"]["flops"] == rec["roofline"]["flops"]


def test_train_cell_fallback_charges_what_it_replicates():
    """gemma3-smoke on 2 x 16, as gemma3-1b on the production mesh: its 8
    (padded) kv heads do not split 16 ways, so the rules replicate
    kv_heads ("size 256 % model(16) != 0"); each model rank then
    computes the K/V projections and, with q gathered to match, the
    attention oracle whole.  Rank 0's FLOPs exceed the one-rank step's /
    32 by exactly (1 - 1/model) of its batch shard's share of those
    products, forward and both adjoints."""
    rec, one, cfg = _train_cell("gemma3-1b", (2, 16), 8)
    assert set(rec["rules_fallbacks"]) == {"kv_heads"}
    assert rec["rules_fallbacks"]["kv_heads"].startswith(
        "size 256 % model(16) != 0")
    dd, md, B, S = 2, 16, 8, 32
    d, hd = cfg.d_model, cfg.head_dim_
    H, Hkv = cfg.n_heads_padded, cfg.n_kv_heads_padded
    kv = 2 * B * S * d * 2 * Hkv * hd
    core = 2 * (2 * B * H * S * S * hd)
    excess = cfg.n_layers * 3 * (kv + core) * (md - 1) // (dd * md)
    assert rec["roofline"]["flops"] * dd * md > one.flops
    assert rec["roofline"]["flops"] - one.flops // (dd * md) == excess


def test_train_cell_counts_collectives_by_kind():
    """A sharded train step's collectives: the FSDP weight all-gathers
    and the gradients' reduce-scatters (and the TP all-reduces), by kind,
    with collective_s their total over the labelled NVLink rate."""
    rec, _, _ = _train_cell("olmo-1b", (2, 4), 8)
    rl = rec["roofline"]
    cb = rl["coll_bytes"]
    assert cb["all-gather"] > 0 and cb["reduce-scatter"] > 0
    assert cb["all-reduce"] > 0
    assert cb["total"] == sum(v for k, v in cb.items() if k != "total")
    assert rl["collective_s"] == cb["total"] / step_stats.NVLINK_BW
    assert step_stats.NVLINK_BW == 450e9
    assert rl["collective_note"] == step_stats.NVLINK_NOTE
    assert rec["analyzer"]["coll_count"]["all-gather"] > 0
    assert rl["step_s"] == max(rl["compute_s"], rl["memory_s"],
                               rl["collective_s"])
    json.dumps(rec)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
def test_ssm_prefill_trip_count_equals_the_unrolled_loop(arch):
    """The serving recurrence's token loop on the meta device: its body
    run once and counted S times gives the same FLOPs, bytes and ops as
    every token dispatched one by one."""
    cfg = _smoke(arch)
    model = registry.build(cfg)
    params = model.init(torch.Generator(), "meta")
    toks = torch.zeros(2, 24, dtype=torch.int32, device="meta")
    got = {}
    for trip in (True, False):
        with StepCounter(trip_counts=trip) as c, torch.no_grad():
            model.prefill(params, toks, LIBRARY)
        got[trip] = (c.flops, c.bytes, c.ops, c.dots)
    assert got[True] == got[False]
    assert got[True][0] > 0


def test_roofline_terms():
    rl = step_stats.Roofline(flops=989e12, hbm_bytes=3.35e12 * 2,
                             model_flops=989e12 / 2)
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(2.0)
    assert rl.dominant == "memory" and rl.step_s == pytest.approx(2.0)
    assert rl.useful_flops_ratio == pytest.approx(0.5)
    assert rl.roofline_fraction == pytest.approx(0.25)
    assert step_stats.PEAK_FLOPS == cost.PEAK_FLOPS_BF16 == 989e12
    assert step_stats.HBM_BW == cost.HBM_BW == 3.35e12


@pytest.mark.parametrize("arch,ok", [("olmo-1b", False), ("gemma3-1b", True),
                                     ("mamba2-780m", True),
                                     ("seamless-m4t-large-v2", False)])
def test_long_context_skips(arch, ok):
    cfg = configs.get_config(arch)
    assert dryrun.shape_applicable(cfg, SHAPES["long_500k"])[0] == ok
    if not ok:
        rec = dryrun.run_cell(arch, "long_500k", False)
        assert rec["status"] == "skipped" and rec["reason"]


def test_cli_json_skip_existing_and_errors(tmp_path, capsys, monkeypatch):
    out = tmp_path / "sub" / "dry.json"
    argv = ["--arch", "olmo-1b", "--shape", "decode_32k,long_500k",
            "--mesh", "single", "--out", str(out)]
    dryrun.main(argv)
    res = json.loads(out.read_text())
    assert res["olmo-1b|decode_32k|single"]["status"] == "ok"
    assert res["olmo-1b|long_500k|single"]["status"] == "skipped"
    assert "1 ok, 1 skipped, 0 errors" in capsys.readouterr().out
    ok = res["olmo-1b|decode_32k|single"]

    def boom(*a, **k):
        raise RuntimeError("boom")
    monkeypatch.setattr(dryrun, "run_cell", boom)
    dryrun.main(argv + ["--skip-existing"])
    text = capsys.readouterr().out
    assert "[skip] olmo-1b|decode_32k|single" in text
    res = json.loads(out.read_text())
    assert res["olmo-1b|decode_32k|single"] == ok
    err = res["olmo-1b|long_500k|single"]
    assert err["status"] == "error" and "boom" in err["trace"]
    assert "1 ok, 0 skipped, 1 errors" in text


def test_no_cuda_and_no_process_group(monkeypatch):
    """A sharded train cell on the production mesh initialises no CUDA
    (DTensor's sharding propagation asks ``torch.cuda.is_available()``,
    a query, each time it enters its fake mode) and takes down the fake
    process group it brought up."""
    import torch.distributed as dist

    def no_cuda(*a, **k):
        raise AssertionError("the dry run touched CUDA")
    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    monkeypatch.setattr(torch.cuda, "init", no_cuda)
    monkeypatch.setattr(torch.cuda, "current_device", no_cuda)
    rec = dryrun.run_cell("olmo-1b", "train_4k", False, accum=1,
                          cfg=_smoke(), shape=ShapeConfig("t", 32, 16,
                                                          "train"))
    assert rec["status"] == "ok" and rec["accum"] == 1
    assert rec["per_device"].startswith("rank 0 of 256")
    assert not dist.is_initialized()
    assert not torch.cuda.is_initialized()
