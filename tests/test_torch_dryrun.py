"""The dry run (``launch/dryrun.py``), its per-aten-op counter
(``launch/step_analyzer.py``) and roofline (``launch/step_stats.py``).

The counter's matmul FLOPs are held to the count worked out from a smoke
config's shapes, and to the same counter around the same step on real
CPU tensors; remat ``full`` must add exactly the blocks' forward FLOPs
(the recompute) and nothing of the embedding or the vocabulary head.  Two
full-size cells run on the meta device; the CLI writes its JSON and
skips what it has; nothing touches CUDA or leaves a process group.

Every cell on a mesh of several ranks, train, prefill or decode, is a
real sharded step under a fake process group of the mesh's size
(``dryrun.fake_world``), counted as rank 0's local ops: with no fallback
its matmul FLOPs are the global count / devices exactly, a rule's
fallback adds the work it replicates, and its collectives are counted by
kind, the split softmax's all-reduces over a cache whose slots are split
included.  The SSM serving recurrence's token loop is trip-counted on
the meta device: the counts equal the unrolled loop's exactly, on one
rank and on a mesh.

The temporaries: the counter's peak of live bytes on the meta device
equals its peak around the same step on real CPU tensors, a hand-counted
two-matmul step gives the expected peak, and the memory terms keep the
reference's identity.
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
from repro_torch.models import layers as L, registry
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
    n = 512 if mesh else 256
    assert rec["devices"] == n
    ma = rec["memory_analysis"]
    assert ma["temp_size_in_bytes"] is not None and ma["temp_note"]
    assert ma["temp_size_in_bytes"] > 0
    assert ma["argument_size_in_bytes"] == sum(ma["arguments"].values())
    assert set(ma["arguments"]) == {"params", "batch", "cache"}
    # the decode step writes the cache in place
    assert ma["alias_size_in_bytes"] == ma["arguments"]["cache"]
    assert ma["total_nonalias"] == sum(ma["port_arguments"].values()) \
        + ma["output_size_in_bytes"] + ma["temp_size_in_bytes"] \
        - ma["alias_size_in_bytes"]
    rl = rec["roofline"]
    # a serving cell is rank 0 of a sharded step: its collectives counted
    assert rec["per_device"].startswith(f"rank 0 of {n}")
    assert rl["coll_bytes"]["total"] > 0
    assert rl["collective_s"] == rl["coll_bytes"]["total"] / \
        step_stats.NVLINK_BW
    assert rl["collective_note"] == step_stats.NVLINK_NOTE
    assert rl["step_s"] == max(rl["compute_s"], rl["memory_s"],
                               rl["collective_s"]) > 0
    assert rl["flops"] == rec["analyzer"]["flops"]
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


def test_moe_train_cell_with_groups_within_a_sequence():
    """mixtral-smoke on 2 x 2 x 2 (pod, data, model) with 4 microbatches
    of a batch of 8: a shard's 2 rows do not split 4 ways, so each
    microbatch is 2 rows cut from the gathered batch, in 4 dispatch
    groups of half a sequence each (as mixtral-8x22b's train_4k cell on
    the 2 x 16 x 16 mesh: 16 rows in 32 groups); the groups' output is
    gathered back to whole rows before the reshape to the batch."""
    cfg = _smoke("mixtral-8x22b", remat="none")
    ms = mesh_mod.mesh_shape((2, 2, 2), ("pod", "data", "model"))
    rec = dryrun.run_cell("mixtral-8x22b", "t", False, accum=4, cfg=cfg,
                          shape=ShapeConfig("t", 32, 8, "train"), mesh=ms)
    assert rec["status"] == "ok"
    assert rec["roofline"]["coll_bytes"]["all-gather"] > 0


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


@pytest.mark.parametrize("mesh", [None, (2, 4)], ids=["one", "2x4"])
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
def test_ssm_prefill_trip_count_equals_the_unrolled_loop(arch, mesh):
    """The serving recurrence's token loop on the meta device: its body
    run twice, the second counted S - 1 times, gives the same FLOPs,
    bytes, ops, collectives and peak of live bytes as every token
    dispatched one by one, on one rank and as rank 0 of a 2 x 4 mesh."""
    model = registry.build(_smoke(arch))
    shape = ShapeConfig("p", 24, 2 if mesh is None else 8, "prefill")
    got = {}
    for trip in (True, False):
        c = StepCounter(trip_counts=trip)
        with api.using(LIBRARY):
            if mesh is None:
                dryrun._run_step(model, shape, ONE, 1, c)
            else:
                with dryrun.fake_world(mesh_mod.mesh_shape(
                        mesh, ("data", "model"))) as dm:
                    dryrun._run_step(model, shape, dm, 1, c)
        got[trip] = (c.flops, c.bytes, c.ops, c.dots, c.peak_live,
                     c.coll_bytes, c.output_bytes)
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
    """A sharded train, prefill and decode cell on the production mesh
    initialises no CUDA
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
    for kind in ("prefill", "decode"):
        rec = dryrun.run_cell("olmo-1b", kind, False, cfg=_smoke(),
                              shape=ShapeConfig(kind, 32, 16, kind))
        assert rec["status"] == "ok"
        assert rec["per_device"].startswith("rank 0 of 256")
        assert not dist.is_initialized()
    assert not torch.cuda.is_initialized()


# --------------------------------------------------------------------------
# Serving cells as sharded steps.
# --------------------------------------------------------------------------

def _serve_cell(arch, mesh, batch, kind, seq=32):
    cfg = _smoke(arch)
    shape = ShapeConfig("s", seq, batch, kind)
    ms = mesh_mod.mesh_shape(mesh, ("data", "model"))
    rec = dryrun.run_cell(arch, "s", False, cfg=cfg, shape=shape, mesh=ms)
    one = dryrun.count_step(cfg, shape, ONE)
    return rec, one, cfg


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serve_cell_without_fallback_splits_every_dot(kind):
    """olmo-smoke's prefill and decode at B 8 on 2 x 4: no fallback, so
    rank 0's matmul FLOPs are the one-rank step's / 8 exactly; the
    row-parallel projections' all-reduces are counted, collective_s their
    total over the NVLink rate; a decode's cache is its argument and its
    alias, a prefill's its output."""
    rec, one, _ = _serve_cell("olmo-1b", (2, 4), 8, kind)
    assert rec["status"] == "ok" and rec["rules_fallbacks"] == {}
    assert rec["per_device"].startswith("rank 0 of 8")
    assert rec["roofline"]["flops"] * 8 == one.flops > 0
    cb = rec["roofline"]["coll_bytes"]
    assert cb["all-reduce"] > 0 and rec["analyzer"]["coll_count"][
        "all-reduce"] > 0
    assert rec["roofline"]["collective_s"] == cb["total"] / \
        step_stats.NVLINK_BW
    ma = rec["memory_analysis"]
    if kind == "decode":
        assert ma["alias_size_in_bytes"] == ma["arguments"]["cache"] > 0
    else:
        assert ma["alias_size_in_bytes"] == 0
        assert ma["output_size_in_bytes"] > 0
    json.dumps(rec)


def test_decode_with_kv_fallback_splits_the_slots_over_model(monkeypatch):
    """gemma3-smoke decode at B 8 on 2 x 16: its 8 kv heads do not split
    16 ways, so the rules put the cache's slots over ``model``; every
    layer's attention is the split softmax, whose max, sum and output
    all-reduces are counted.  Rank 0's FLOPs exceed the one-rank step's
    / 32 by exactly what the fallback replicates: the K/V projections of
    its batch shard on every model rank (the split attention itself is
    an exact share)."""
    calls = []
    real = L.split_decode_attend

    def spy(*a, **k):
        calls.append(k["ring"])
        return real(*a, **k)
    monkeypatch.setattr(L, "split_decode_attend", spy)
    rec, one, cfg = _serve_cell("gemma3-1b", (2, 16), 8, "decode")
    assert set(rec["rules_fallbacks"]) == {"kv_heads"}
    assert calls == [32] * cfg.n_layers
    dd, md, B = 2, 16, 8
    d, hd, H = cfg.d_model, cfg.head_dim_, cfg.n_heads_padded
    kv = 2 * B * d * 2 * cfg.n_kv_heads_padded * hd
    excess = cfg.n_layers * kv * (md - 1) // (dd * md)
    assert rec["roofline"]["flops"] - one.flops // (dd * md) == excess
    # the split softmax's all-reduces alone: max and sum (B/dd, H, 1) f32
    # and the output (B/dd, H, hd) f32, a layer
    split = cfg.n_layers * (B // dd) * H * 4 * (2 + hd)
    assert rec["roofline"]["coll_bytes"]["all-reduce"] >= split
    assert rec["analyzer"]["coll_count"]["all-reduce"] >= 3 * cfg.n_layers


@pytest.mark.parametrize("arch", ["mamba2-780m", "gemma3-1b",
                                  "mixtral-8x22b"])
def test_batch_one_decode_splits_the_slots_over_data(arch, monkeypatch):
    """B 1 (the long-context cells): the batch does not split, so the
    rules put the cache's slots over ``data`` (mixtral's 32-slot ring
    included); each attention layer's decode is the split softmax, and
    the SSM carries stay whole on every rank."""
    calls = []
    real = L.split_decode_attend
    monkeypatch.setattr(L, "split_decode_attend",
                        lambda *a, **k: calls.append(k["ring"])
                        or real(*a, **k))
    rec, one, cfg = _serve_cell(arch, (2, 4), 1, "decode", seq=64)
    assert rec["status"] == "ok"
    assert rec["per_device"].startswith("rank 0 of 8")
    attn = 0 if cfg.family == "ssm" else cfg.n_layers
    ring = 32 if cfg.attn.kind == "swa" else 64
    assert calls == [ring] * attn
    assert rec["analyzer"]["coll_count"]["all-reduce"] >= 3 * attn
    assert 0 < rec["roofline"]["flops"] <= one.flops
    ma = rec["memory_analysis"]
    assert ma["alias_size_in_bytes"] == ma["arguments"]["cache"] > 0


# --------------------------------------------------------------------------
# Temporaries.
# --------------------------------------------------------------------------

def _olmo_steps(dev):
    """olmo-smoke's train step, prefill and decode on ``dev`` under the
    counter: {kind: (peak_live, live after, output bytes, alias bytes)}."""
    cfg = _smoke()
    model = registry.build(cfg)
    out = {}
    st = TL.init_train_state(model, torch.Generator().manual_seed(0), dev)
    batch = {k: torch.zeros(2, 16, dtype=torch.int32, device=dev)
             for k in ("tokens", "labels")}
    params = model.init(torch.Generator().manual_seed(0), dev)
    toks = batch["tokens"]
    cache = model.init_cache(2, 16, torch.bfloat16, device=dev)
    one = toks[:, :1]
    steps = {"train": ((st, batch), lambda: TL.make_train_step(
                 model, TL.TrainConfig(), LIBRARY)(st, batch)),
             "prefill": ((params, toks), lambda: model.prefill(
                 params, toks, LIBRARY)),
             "decode": ((params, one, cache), lambda: model.decode(
                 params, one, cache, LIBRARY))}
    for kind, (args, fn) in steps.items():
        with api.using(LIBRARY), torch.set_grad_enabled(kind == "train"):
            with StepCounter() as c:
                res = fn()
        c.returned(args, res)
        out[kind] = (c.peak_live, c.live, c.output_bytes, c.alias_bytes)
    return out, cache


def test_meta_peak_equals_the_peak_on_real_tensors():
    """The counter's peak of live bytes, and the output and alias bytes,
    of olmo-smoke's train step, prefill and decode: the same on the meta
    device as on CPU tensors, exactly.  The train step updates the
    params and both moments in place (aliases), the decode its cache."""
    meta, cache = _olmo_steps("meta")
    cpu, _ = _olmo_steps("cpu")
    assert meta == cpu
    assert all(v[0] > 0 for v in meta.values())
    cache_b = sum(t.numel() * t.element_size()
                  for t in (cache.attn_k, cache.attn_v))
    assert meta["decode"][3] == cache_b
    assert meta["prefill"][3] == 0
    assert meta["train"][3] > 0


@pytest.mark.parametrize("dev", ["meta", "cpu"])
def test_two_matmul_peak_by_hand(dev):
    """x (4, 8) @ w1 (8, 16) -> h, h @ w2 (16, 2) -> y, then h dropped:
    the peak is h and y at once (256 + 32 bytes), y alone stays live."""
    x, w1, w2 = (torch.ones(s, device=dev) for s in ((4, 8), (8, 16),
                                                      (16, 2)))
    with StepCounter() as c:
        h = x @ w1
        y = h @ w2
        del h
    assert (c.peak_live, c.live) == (4 * 16 * 4 + 4 * 2 * 4, 4 * 2 * 4)
    c.returned((x, w1, w2), y)
    assert (c.output_bytes, c.alias_bytes) == (32, 0)
    del y
    assert c.live == 0


def test_memory_terms_identity():
    ma = step_stats.memory_analysis_terms(
        {"params": 100, "cache": 40}, {"params": 110, "cache": 40},
        peak_live=70, output=50, alias=40)
    assert ma["argument_size_in_bytes"] == 140
    assert ma["total_nonalias"] == 150 + 70
    assert ma["temp_size_in_bytes"] == 70 - 50 + 40
    assert ma["total_nonalias"] == sum(ma["port_arguments"].values()) + \
        ma["output_size_in_bytes"] + ma["temp_size_in_bytes"] - \
        ma["alias_size_in_bytes"]
