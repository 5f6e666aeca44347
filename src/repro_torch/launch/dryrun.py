"""The dry run: every (architecture x input shape x mesh) cell at full
width and depth on the meta device, with no CUDA (counterpart of
``repro/launch/dryrun.py``).

Each cell builds the parameters, the optimizer state, the cache and the
batch on the meta device (shapes and dtypes, no storage), runs the
cell's step once under the library policy and the activation context of
the production mesh, and reports:

  * the step as a real sharded step: a fake process group of the mesh's
    size comes up in this process (:func:`fake_world`, torn down after
    the cell), the state or the serving weights, the batch and a decode
    cell's cache are meta DTensors laid out by the rules (the
    reference's ``in_shardings``: ``Rules.distribute``, ``data_specs``,
    ``cache_shardings``), and a prefill returns its cache in the cache
    layout (the reference's ``out_shardings``).  A train cell runs the
    train step, a prefill cell ``model.prefill``, a decode cell one
    ``model.decode`` step over a full cache.  The counter counts rank 0's
    local ops, so the FLOPs, bytes and memory are one rank's, the work a
    rule's fallback replicates included, and the collectives DTensor and
    the split softmax emit are counted by kind with their bytes
    (``coll_bytes``, ``collective_s``).  On a mesh of one rank (the
    anchor) the step runs on plain meta tensors.
  * ``memory_analysis`` (``step_stats.memory_analysis_terms``):
    ``argument_size_in_bytes``, one device's bytes of the step's
    arguments from the rules' local shapes (a train step: the f32
    master, both moments and the int32 step, as a checkpoint holds them,
    plus tokens and labels; serving: the weights, every floating leaf in
    bf16 as the reference deploys them, plus tokens and, for decode, the
    cache).  The port keeps a cache's ``pos`` on the host, where the
    reference holds a 4-byte device scalar; its serving module keeps the
    router, the norms and the SSM vectors in f32: ``port_arguments``
    counts the weights so.  The output and alias bytes of what the step
    returned, ``total_nonalias`` (the port's arguments plus the step's
    peak of live allocations, measured by the counter) and the
    temporaries.
  * ``analyzer``: the step's matmul FLOPs and operand + output bytes,
    counted per aten op (``step_analyzer.StepCounter``), and
    ``roofline`` (``step_stats.Roofline``) on them.
  * ``model_flops_per_dev``: the reference's 6·N·D (2·N·D to serve).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape decode_32k --mesh single

A cell that fails is logged with its traceback and the run goes on; it
is never counted again some other way.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import pathlib
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import api, configs
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import step_stats
from repro_torch.launch.step_analyzer import StepCounter
from repro_torch.models.common import STRUCTS, Struct
from repro_torch.models.registry import build as build_model
from repro_torch.parallel import rules as R
from repro_torch.parallel.ctx import activation_axes, activation_sharding
from repro_torch.train import loop as train_loop

# per-(arch, shape) gradient-accumulation overrides (the reference's)
ACCUM = {"train_4k": 8}
ACCUM_ARCH = {("mixtral-8x22b", "train_4k"): 16}

#: the policy every cell runs under: no kernel launches, every op an aten op
LIBRARY = api.named_policy("library")

DEFAULT_OUT = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "dryrun.json"


def input_structs(cfg, shape) -> Dict[str, Struct]:
    """The step's batch inputs (the reference's ``input_specs``): int32
    tokens (and labels to train), bf16 frontend embeddings."""
    B, S, d = shape.global_batch, shape.seq_len, cfg.d_model
    tok, emb = torch.int32, torch.bfloat16
    if shape.kind == "decode":
        return {"tokens": Struct((B, 1), tok)}
    text = S - cfg.frontend_tokens if cfg.frontend == "vision" else S
    out = {"tokens": Struct((B, text), tok)}
    if shape.kind == "train":
        out["labels"] = Struct((B, text), tok)
    if cfg.frontend == "vision":
        out["prefix_embeds"] = Struct((B, cfg.frontend_tokens, d), emb)
    if cfg.frontend == "audio":
        out["src_embeds"] = Struct((B, S, d), emb)
    return out


def model_flops(cfg, shape) -> float:
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch     # decode: one token per seq


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _bytes(tree) -> int:
    return sum(s.nbytes for s in _leaves(tree))


def _serving(tree):
    """Every floating leaf in bf16 (the reference's ``_serving_params``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _serving(v) for k, v in tree.items()}
    return Struct(tree.shape, torch.bfloat16) \
        if tree.dtype.is_floating_point else tree


def _meta(s: Struct) -> torch.Tensor:
    return torch.zeros(s.shape, dtype=s.dtype, device="meta")


def _cache_bytes(cache, cspecs, mesh) -> int:
    """One device's bytes of a cache's tensors (``pos`` is a host int)."""
    return sum(math.prod(R.spec_local_shape(mesh, cspecs.get(f.name, ()),
                                            v.shape)) * v.element_size()
               for f in dataclasses.fields(cache)
               for v in [getattr(cache, f.name)]
               if isinstance(v, torch.Tensor))


@functools.lru_cache(maxsize=32)
def param_structs(cfg, dtype: Optional[torch.dtype] = None):
    """The parameters' :class:`Struct` tree (``params_to_numpy``'s) of the
    module ``cfg`` builds, its matmul weights in ``dtype`` (default: the
    compute dtype), from a build on the meta device.  Cached: callers
    read the tree and build new ones from it, never change it."""
    model = build_model(cfg)
    return train_loop._family(cfg).params_to_numpy(
        model.init(torch.Generator(), "meta", dtype), cfg, STRUCTS)


def argument_bytes(cfg, shape, mesh, *, fsdp: bool = True
                   ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """One device's bytes of the cell's step arguments by group (state or
    params, batch, cache), as the reference counts them and as the port
    stores them (``port``: the serving weights in the module's own
    dtypes); from the rules' local shapes of meta tensors, no step run."""
    model = build_model(cfg)
    rules = R.make_rules(cfg, mesh, fsdp=fsdp)
    dspecs = R.data_specs(cfg, shape, mesh, rules)
    args = {"batch": sum(
        math.prod(R.spec_local_shape(mesh, dspecs[k], s.shape))
        * s.dtype.itemsize for k, s in input_structs(cfg, shape).items())}
    if shape.kind == "train":
        ps = param_structs(cfg, torch.float32)
        st = {"params": ps, "opt": {"m": ps, "v": ps},
              "step": Struct((), torch.int32)}
        args["state"] = _bytes(rules.tree_local(
            train_loop.train_state_specs(model), st))
        return args, dict(args)
    specs = model.specs()
    ps = param_structs(cfg)
    args["params"] = _bytes(rules.tree_local(specs, _serving(ps)))
    port = dict(args, params=_bytes(rules.tree_local(specs, ps)))
    if shape.kind == "decode":
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 torch.bfloat16, device="meta")
        args["cache"] = port["cache"] = _cache_bytes(
            cache, R.cache_shardings(cfg, shape, mesh, rules), mesh)
    return args, port


@contextlib.contextmanager
def fake_world(mesh):
    """A ``DeviceMesh`` of ``mesh``'s shape (a :class:`R.MeshShape`) over
    a fake process group of its size in this process, as its rank 0: its
    collectives move nothing, which meta tensors need not.  The group is
    taken down on exit; a group already up raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is up: the dry run brings up "
                           "its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size())
    try:
        yield init_device_mesh("cpu", tuple(mesh.shape),
                               mesh_dim_names=tuple(mesh.mesh_dim_names))
    finally:
        dist.destroy_process_group()


def _run_step(model, shape, mesh, accum: int, counter) -> None:
    """The cell's step on meta tensors over ``mesh``: a ``DeviceMesh``
    (every leaf a DTensor laid out by the rules) or a one-rank
    :class:`R.MeshShape` (plain tensors), counted by ``counter`` (its
    output and alias bytes recorded: ``StepCounter.returned``)."""
    cfg = model.cfg
    sharded = not isinstance(mesh, R.MeshShape)
    rules = R.make_rules(cfg, mesh)
    gen = torch.Generator()

    def place(tree, specs):
        return rules.distribute(tree, specs) if sharded else tree
    dspecs = R.data_specs(cfg, shape, mesh, rules)
    batch = {k: place(_meta(s), dspecs[k])
             for k, s in input_structs(cfg, shape).items()}
    act = activation_axes(cfg, mesh, R.batch_spec(mesh, shape.global_batch))
    with activation_sharding(mesh, act):
        if shape.kind == "train":
            step = train_loop.make_train_step(
                model, train_loop.TrainConfig(accum_steps=accum), LIBRARY)
            args = (place(train_loop.init_train_state(model, gen, "meta"),
                          train_loop.train_state_specs(model)), batch)
            with counter:
                out = step(*args)
            counter.returned(args, out)
            return
        params = place(model.init(gen, "meta"), model.specs())
        extra = {k: v for k, v in batch.items() if k.endswith("embeds")}
        with torch.no_grad():
            if shape.kind == "prefill":
                args = (params, batch)
                with counter:
                    out = model.prefill(params, batch["tokens"], LIBRARY,
                                        **extra)
            else:
                cache = model.init_cache(shape.global_batch, shape.seq_len,
                                         torch.bfloat16, device="meta",
                                         mesh=mesh if sharded else None)
                args = (params, batch, cache)
                with counter:
                    out = model.decode(params, batch["tokens"], cache,
                                       LIBRARY)
    counter.returned(args, out)


def count_step(cfg, shape, mesh, *, accum: int = 1) -> StepCounter:
    """The cell's step run once on the meta device under the library
    policy and the mesh's activation context, counted per aten op: a
    train step (``accum`` microbatches), a prefill, or one decode step
    over a full cache.  On a mesh of several ranks a real sharded step
    under a fake process group of its size, counted as rank 0's
    (:func:`_run_step`)."""
    model = build_model(cfg)
    counter = StepCounter()
    with api.using(LIBRARY):
        if mesh.size() > 1:
            with fake_world(mesh) as dm:
                _run_step(model, shape, dm, accum, counter)
        else:
            _run_step(model, shape, mesh, accum, counter)
    return counter


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             fsdp: bool = True, accum: Optional[int] = None,
             mesh=None, cfg=None, shape=None) -> Dict[str, Any]:
    """One cell's record.  ``mesh``, ``cfg`` and ``shape`` replace the
    production mesh, the arch's config and ``SHAPES[shape_name]`` (a
    smaller cell: tests and the on-card anchor)."""
    cfg = cfg or configs.get_config(arch)
    shape = shape or SHAPES[shape_name]
    name = "multi" if multi_pod else "single"
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": name,
                "status": "skipped", "reason": why}
    t0 = time.time()
    mesh = mesh or mesh_mod.production_shape(multi_pod)
    n_dev = mesh.size()
    args, port = argument_bytes(cfg, shape, mesh, fsdp=fsdp)
    acc = None
    if shape.kind == "train":
        acc = accum if accum is not None else ACCUM_ARCH.get(
            (arch, shape_name), ACCUM.get(shape_name, 1))
    counter = count_step(cfg, shape, mesh, accum=acc or 1)
    mf = model_flops(cfg, shape) / n_dev
    rl = step_stats.Roofline(
        flops=counter.flops, hbm_bytes=counter.bytes, model_flops=mf,
        coll_bytes=counter.coll_bytes if n_dev > 1 else None)
    ma = step_stats.memory_analysis_terms(
        args, port, peak_live=counter.peak_live,
        output=counter.output_bytes, alias=counter.alias_bytes)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": name, "status": "ok",
        "devices": n_dev, "count_s": round(time.time() - t0, 2),
        "memory_analysis": ma, "model_flops_per_dev": mf,
        "roofline": rl.as_dict(), "analyzer": counter.as_dict(),
        "per_device": (f"rank 0 of {n_dev}: its local ops in a sharded "
                       "step under a fake process group") if n_dev > 1
        else "the one rank's step",
        "rules_fallbacks": R.make_rules(cfg, mesh, fsdp=fsdp).fallbacks,
    }
    if acc is not None:
        rec["accum"] = acc
    return rec


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = configs.ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results: Dict[str, Any] = {}
    if args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = f"{arch}|{shape}|{'multi' if mp else 'single'}"
                if args.skip_existing and \
                        results.get(key, {}).get("status") == "ok":
                    print(f"[skip] {key}")
                    continue
                print(f"[cell] {key} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, mp, fsdp=not args.no_fsdp,
                                   accum=args.accum)
                except Exception as e:  # noqa: BLE001 — log and continue
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "status": "error", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                results[key] = rec
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r, ma = rec["roofline"], rec["memory_analysis"]
                    extra = (f" dom={r['dominant']}"
                             f" frac={r['roofline_fraction']:.3f}"
                             f" args/dev="
                             f"{ma['argument_size_in_bytes'] / 2**30:.3f}GiB"
                             f" mem/dev={ma['total_nonalias'] / 2**30:.2f}GiB"
                             f" count={rec['count_s']}s")
                elif status == "error":
                    extra = " " + rec["error"][:200]
                print(f"[done] {key}: {status}{extra}", flush=True)

    n = {s: sum(1 for r in results.values() if r["status"] == s)
         for s in ("ok", "skipped", "error")}
    print(f"dry-run complete: {n['ok']} ok, {n['skipped']} skipped, "
          f"{n['error']} errors")
    return results


if __name__ == "__main__":
    main()
