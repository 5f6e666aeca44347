"""Training launcher (counterpart of ``repro/launch/train.py``): config
-> mesh -> rules -> f32 train state -> train loop under the activation
context, with checkpointing, fault handling, straggler monitoring and
deterministic data.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --backend auto --steps 50 --batch 8 --seq 128 \
        --ckpt-dir build/ckpt --ckpt-every 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --smoke --steps 8 --batch 4 --seq 32 --device cpu

The reference's flags, plus ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain versions).  ``--backend`` routes the GEMMs (default
``library``, the reference's ``xla``); the non-GEMM kernels (flash,
grouped, SSD) have no backward, so they are pinned to the library
(``Policy.kernels``), as the reference pins them to XLA.  Weights are
random, drawn from ``--seed`` by a ``torch.Generator`` on the device.
Checkpoints are the reference's format (``train/checkpoint.py``): a
``--ckpt-dir`` the JAX trainer wrote resumes here and the other way
round.  The data are tokens only, as the reference's, so the families
that need frontend embeddings (VLM, audio) are refused; their batches go
through ``train.loop.make_train_step`` directly.

The mesh is the 1 x 1 host mesh of one rank (``launch/mesh.py``: a
one-rank NCCL group on the card, gloo on the CPU, taken down at the
end); the sharding rules (``parallel/rules.py``) are logged, and the
loop runs in the activation context (``parallel/ctx.py``), as the
reference's.  ``--production-mesh`` (``--multi-pod``) asks for the
16 x 16 (2 x 16 x 16) mesh, which raises unless the world holds its 256
(512) ranks; a mesh of more than one rank raises too, because running
on several ranks is not ported (ROADMAP §1 item 6).
"""
from __future__ import annotations

import argparse
import logging
import time
import torch

from repro_torch import api, configs, obs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.registry import build as build_model
from repro_torch.parallel import rules as R
from repro_torch.parallel.ctx import activation_axes, activation_sharding
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import data as data_mod
from repro_torch.train import fault
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt

log = logging.getLogger("repro_torch.train")


def build_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--backend", default="library",
                    choices=list(api.POLICY_NAMES))
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--inject-fault-at", type=int, default=-1,
                    help="simulate a node failure at this step (testing)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Train as ``args`` say; returns the last step's metrics (``loss``,
    ``grad_norm``, ``lr``, ``step``), ``final_step``, the monitor's
    summary and ``history`` (each executed step's metrics and seconds, a
    restart's replayed steps included)."""
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    if cfg.frontend is not None:
        raise ValueError(
            f"{cfg.name}: the launcher trains on tokens alone, and the "
            f"{cfg.family} family needs {cfg.frontend} frontend embeddings; "
            "pass them in the batch to train.loop.make_train_step")
    device = args.device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run the plain versions)")
    mesh = mesh_mod.make_production_mesh(
        multi_pod=args.multi_pod, device_type=torch.device(device).type) \
        if args.production_mesh else mesh_mod.make_host_mesh(device)
    try:
        return _run(args, cfg, device, mesh)
    finally:
        mesh_mod.release_mesh()


def _run(args, cfg, device, mesh) -> dict:
    if mesh.size() > 1:
        raise NotImplementedError(
            f"a mesh of {mesh.size()} ranks: training on several ranks "
            "(state placed by the rules as DTensors) is not ported yet "
            "(ROADMAP §1 item 6); train on the host mesh")
    model = build_model(cfg)
    rules = R.make_rules(cfg, mesh)
    log.info("sharding rules on %s:\n%s", dict(R.axis_sizes(mesh)),
             rules.report())
    act_axes = activation_axes(cfg, mesh, R.batch_spec(mesh, args.batch))
    # the one policy install of the run: GEMM routing as --backend says,
    # the kernels without a backward pinned to the library
    be = api.install(api.named_policy(args.backend).replace(
        kernels="library"))
    tc = train_loop.TrainConfig(
        opt=opt.OptConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                          decay_steps=max(args.steps, 10)),
        accum_steps=args.accum)
    step_fn = train_loop.make_train_step(model, tc, be)
    data = data_mod.SyntheticTokens(cfg.vocab, args.seq, args.batch,
                                    seed=args.seed)
    ckpt = ckpt_mod.Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    monitor = fault.StepMonitor()
    metrics_out = {"history": []}

    def train_once(attempt: int) -> int:
        start_step = 0
        state = None
        if ckpt and (args.resume or attempt > 0):
            ckpt.wait()          # a save still in flight counts as written
            latest = ckpt.latest_step()
            if latest is not None:
                tree, extra = ckpt.restore()
                state = train_loop.state_from_numpy(tree, cfg, device)
                start_step = int(extra.get("data_step", latest))
                log.info("restored step %d", start_step)
        if state is None:
            gen = torch.Generator(device=device).manual_seed(args.seed)
            state = train_loop.init_train_state(model, gen, device)
        for step in range(start_step, args.steps):
            if step == args.inject_fault_at and attempt == 0:
                raise fault.SimulatedFault(f"injected at step {step}")
            monitor.start()
            t0 = time.perf_counter()
            with obs.span("train.step"):
                gb = data_mod.to_device(data.batch(step), device)
                state, m = step_fn(state, gb)
                m = {k: float(v) for k, v in m.items()}   # waits for it
            dt = time.perf_counter() - t0
            monitor.stop(step)
            train_loop.record_step(step, m, dt)
            metrics_out.update(m, step=step)
            metrics_out["history"].append(dict(m, step=step, seconds=dt))
            if step % args.log_every == 0 or step == args.steps - 1:
                log.info("step %d loss %.4f gnorm %.3f lr %.2e",
                         step, m["loss"], m["grad_norm"], m["lr"])
            if ckpt and args.ckpt_every and \
                    (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, train_loop.state_to_numpy(state, cfg),
                          extra={"data_step": step + 1}, async_=True)
        if ckpt:
            ckpt.save(args.steps, train_loop.state_to_numpy(state, cfg),
                      extra={"data_step": args.steps})
            ckpt.wait()
        return args.steps

    with activation_sharding(mesh, act_axes):
        final = fault.run_with_restarts(train_once,
                                        max_restarts=args.max_restarts)
    metrics_out["final_step"] = final
    metrics_out["monitor"] = monitor.summary()
    return metrics_out


def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    out = run(build_args())
    print({k: v for k, v in out.items() if k != "history"})


if __name__ == "__main__":
    main()
