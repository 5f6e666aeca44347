"""Training on every card of one host: olmo-1b at full width and depth on
meshes of all the host's ranks over NCCL, against one rank's step.

    torchrun --nproc-per-node 4 chip_mesh.py

Each rank is one card (``launch.mesh.init_world``: NCCL, ``cuda:
LOCAL_RANK``).  Rank 0 builds the port's kernels, then the other ranks
load them.  For each mesh of the world's N ranks (1 x N: heads, mlp and
vocab on ``model``; N x 1: embed on ``data``, the batch split; 2 x N/2
where N is even) the steps of ``chip_smoke.py``'s "mesh train" run on
it (B 4 x S 64 from one seeded state, 3 steps under ``auto``, f32 with
the step-1 gradients, and bf16; IAAT launches and local shapes a step);
rank 0 then runs the one-rank steps on its card and holds every mesh to
them with that phase's tolerances.  One bf16 step on the 2 x N/2 mesh
is traced on rank 0 (device time of the NCCL kernels, the IAAT kernel,
the library's GEMMs and the rest).  Then the launcher itself,
``launch.train._run`` on the 2 x N/2 mesh at full width and 2 of the 16
layers: 3 steps, and 2 steps with a checkpoint a step (rank 0 writes
whole arrays into a directory under build/) followed by ``--resume`` to
3 steps (each rank reads its shards): the resumed last loss equals the
uninterrupted one.  Writes ``chiprun_out/chip_mesh.json``; rank 0
prints the card's name and power limit, then one line a finding, and,
when every check passed, ``{"ok": true, ...}`` last.
"""
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import chip_smoke as C

#: the launcher's depth cut (of olmo-1b's 16 layers): its checkpoints
#: hold 2.85 GB of f32 master, m and v, written twice
LAUNCH_LAYERS = 2
#: the resumed run's last loss against the uninterrupted run's, relative
RESUME_TOL = 1e-6


def _meshes(n):
    out = [(1, n), (n, 1)]
    if n % 2 == 0 and n > 2:
        out.append((2, n // 2))
    return out


def _profile_step(torch, cfg, mesh, tokens, pol, primary):
    """One warm bf16 step on ``mesh``, traced on rank 0: device ms of the
    NCCL kernels, the IAAT kernel, the library's GEMMs and the rest, and
    the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import registry
    from repro_torch.parallel import rules as R, spmd
    from repro_torch.parallel.ctx import activation_axes, activation_sharding
    from repro_torch.train import data as D
    from repro_torch.train import loop as TL
    model = registry.build(cfg)
    rules = R.make_rules(cfg, mesh)
    st = rules.distribute(TL.init_train_state(
        model, torch.Generator(device="cuda").manual_seed(0), "cuda"),
        TL.train_state_specs(model))
    dpl = R.data_shardings(cfg, ShapeConfig("m", C.MESH_S, C.MESH_B,
                                            "train"), mesh, rules)
    host, hosts = spmd.shard_coordinate(mesh, dpl["tokens"])
    rows = C.MESH_B // hosts
    batch = D.make_global_batch({k: torch.from_numpy(
        v[host * rows:(host + 1) * rows]).long().to("cuda")
        for k, v in tokens.items()}, mesh, dpl)
    step = TL.make_train_step(model, TL.TrainConfig(), pol)
    with activation_sharding(mesh, activation_axes(
            cfg, mesh, R.batch_spec(mesh, C.MESH_B))):
        st, m = step(st, batch)                       # warm-up
        float(m["loss"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     ) if primary else contextlib.nullcontext() as prof:
            st, m = step(st, batch)
            float(m["loss"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups = {"nccl": 0.0, "iaat_gemm": 0.0, "library_gemm": 0.0,
              "other": 0.0}
    if primary:
        for e in prof.key_averages():
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            t = getattr(e, "self_device_time_total", 0.0) / 1e3
            key = e.key.lower()
            grp = "nccl" if "nccl" in key else "iaat_gemm" if \
                "iaat_gemm" in key else "library_gemm" if any(
                    w in key for w in ("gemm", "xmma", "cutlass")) \
                else "other"
            groups[grp] += t
    del st, step
    C._free(torch)
    return {"wall_s": wall, "device_ms": groups}


def _launcher(torch, mesh, root):
    """``launch.train._run`` on ``mesh`` (olmo-1b, LAUNCH_LAYERS layers,
    ``auto``): 3 steps; 2 steps with a checkpoint a step, then resumed to
    3.  The last losses of both."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import train as train_mod
    cfg = dataclasses.replace(configs.get_config("olmo-1b"),
                              n_layers=LAUNCH_LAYERS)
    ckpt = os.path.join(root, "build", "chip_mesh_ckpt")
    if dist.get_rank() == 0 and os.path.exists(ckpt):
        shutil.rmtree(ckpt)
    dist.barrier()

    def run(*argv):
        args = train_mod.build_args(
            ["--arch", "olmo-1b", "--batch", str(C.MESH_B), "--seq",
             str(C.MESH_S), "--backend", "auto", "--log-every", "100",
             "--device", "cuda", *argv])
        return train_mod._run(args, cfg, "cuda", mesh)
    whole = run("--steps", "3")
    run("--steps", "2", "--ckpt-dir", ckpt, "--ckpt-every", "1")
    resumed = run("--steps", "3", "--ckpt-dir", ckpt, "--resume")
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    return {"whole": [h["loss"] for h in whole["history"]],
            "resumed": [h["loss"] for h in resumed["history"]],
            "resumed_steps": [h["step"] for h in resumed["history"]]}


def main():
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("chip_mesh: no CUDA device", file=sys.stderr)
        return 2
    root = C.ROOT
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_mesh: run from a checkout of the repository",
              file=sys.stderr)
        return 3
    if "RANK" not in os.environ:
        print("chip_mesh: start it with torchrun --nproc-per-node N",
              file=sys.stderr)
        return 4
    sys.path.insert(0, str(root / "src"))
    from repro_torch import api, configs
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh_mod.init_world("cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    primary = rank == 0
    t_start = time.perf_counter()
    report = {"world": world, "torch": torch.__version__}
    ok = True
    try:
        if primary:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip()
            print(card, flush=True)
            report["card"] = card
            build.load()
        dist.barrier()
        build.load()
        report["build_s"] = time.perf_counter() - t_start
        pol = api.Policy(backend="auto").replace(kernels="library")
        api.install(pol)
        base = configs.get_config("olmo-1b")
        cfgs = {dt: dataclasses.replace(base, dtype=dt)
                for dt in ("float32", "bfloat16")}
        tokens = C._mesh_tokens(base)
        runs = {}
        for shape in _meshes(world):
            mesh = mesh_mod.make_mesh(shape, ("data", "model"), "cuda")
            runs[shape] = {dt: C._mesh_run(torch, cfgs[dt], mesh, tokens,
                                           pol, dt == "float32")
                           for dt in cfgs}
        report["peak_bytes"] = torch.cuda.max_memory_allocated()
        verdict = {}
        if primary:
            one = {dt: C._mesh_run(torch, cfgs[dt], None, tokens, pol,
                                   dt == "float32") for dt in cfgs}
            verdict = {s: C._mesh_compare(torch, r, one)
                       for s, r in runs.items()}
            report["one_rank"] = {dt: {k: v for k, v in r.items()
                                       if k != "grads"}
                                  for dt, r in one.items()}
            del one
        for r in runs.values():
            r["float32"].pop("grads", None)
        dist.barrier()
        shape = _meshes(world)[-1]
        mesh = mesh_mod.make_mesh(shape, ("data", "model"), "cuda")
        prof = _profile_step(torch, cfgs["bfloat16"], mesh, tokens, pol,
                             primary)
        launch = _launcher(torch, mesh, root)
        gathered = [None] * world
        dist.all_gather_object(gathered, {
            "rank": rank, "peak_bytes": report["peak_bytes"],
            "runs": {f"{s[0]}x{s[1]} {dt}": r
                     for s, rs in runs.items() for dt, r in rs.items()}})
        if primary:
            for g in gathered:
                for name, r in g["runs"].items():
                    C.log(f"chip_mesh rank {g['rank']} {name}: losses "
                          f"{[round(x, 6) for x in r['losses']]}, step s "
                          f"{[round(x, 4) for x in r['step_s']]}, IAAT "
                          f"launches a step {r['iaat']}, local MxKxN "
                          f"{r['shapes']}")
                C.log(f"chip_mesh rank {g['rank']}: peak memory "
                      f"{g['peak_bytes'] / 2**30:.2f} GiB")
            for dt, r in report["one_rank"].items():
                C.log(f"chip_mesh one rank {dt}: losses "
                      f"{[round(x, 6) for x in r['losses']]}, step s "
                      f"{[round(x, 4) for x in r['step_s']]}")
            for s, v in verdict.items():
                C.log(f"chip_mesh {s[0]}x{s[1]} against one rank: f32 "
                      f"losses {v['loss_rel']:.3g} rel, step-1 gradients "
                      f"{v['grad_rel']:.3g} of max|g| (worst "
                      f"{v['grad_worst_leaf']}), bf16 losses "
                      f"{v['bf16_loss_rel']:.3g} rel")
            C.log(f"chip_mesh profile {shape[0]}x{shape[1]} bf16 step: "
                  f"wall {prof['wall_s'] * 1e3:.2f} ms, device ms "
                  f"{ {k: round(v, 3) for k, v in prof['device_ms'].items()} }")
            rel = abs(launch["resumed"][-1] - launch["whole"][-1]) / \
                abs(launch["whole"][-1])
            C.log(f"chip_mesh launcher {shape[0]}x{shape[1]} "
                  f"({LAUNCH_LAYERS} layers): losses {launch['whole']}, "
                  f"resumed at steps {launch['resumed_steps']} "
                  f"{launch['resumed']} ({rel:.3g} rel)")
            no_kernel = [(g["rank"], n) for g in gathered
                         for n, r in g["runs"].items() if min(r["iaat"]) < 1]
            ok = all(v["ok"] for v in verdict.values()) and not no_kernel \
                and rel <= RESUME_TOL and launch["resumed_steps"] == [2]
            report.update(ranks=gathered, profile=prof, launcher=launch,
                          verdict={f"{s[0]}x{s[1]}": v
                                   for s, v in verdict.items()},
                          seconds=time.perf_counter() - t_start)
            C.OUT_DIR.mkdir(exist_ok=True)
            (C.OUT_DIR / "chip_mesh.json").write_text(
                json.dumps(report, indent=1, default=str))
            C.log(f"chip_mesh: {report['seconds']:.1f} s, "
                  f"{'ok' if ok else 'FAILED'}")
    except Exception:
        traceback.print_exc()
        ok = False
    finally:
        mesh_mod.release_mesh()
    if primary and ok:
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": world}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
