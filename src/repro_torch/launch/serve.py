"""Serving launcher: paged continuous-batched generation on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
        --backend auto --requests 6 --max-new 16

``--arch`` takes every registered config: the dense olmo-1b, gemma3-1b,
smollm-360m and glm4-9b, the MoE moonshot-v1-16b-a3b and mixtral-8x22b,
the ssm mamba2-780m and the hybrid zamba2-7b (whose carries live in the
engine's per-slot rows), and the VLM internvl2-2b, served on text as the
reference serves it.  The enc-dec seamless-m4t-large-v2 is refused, as
the reference's launcher refuses it: the paged engine has no enc-dec
path (``registry.build`` gives that model no paged entries); it runs
through ``registry.Model``'s ``prefill`` and ``decode``.

Counterpart of ``repro/launch/serve.py``, with the same flags plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).  Weights are random, drawn from ``--seed`` by a
``torch.Generator`` on the device.  ``--online-tune`` runs the online
re-tuner between the engine's steps (on the card it times the kernels and
the library on its own stream); ``--trace PATH`` writes the flight
recorder as a Perfetto JSON after the run::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
        --backend tuned --online-tune --trace build/serve_trace.json
    PYTHONPATH=src python -m repro_torch.obs trace build/serve_trace.json \
        build/serve_trace_again.json
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import List

import numpy as np
import torch

from repro_torch import api, configs
from repro_torch.models import encdec
from repro_torch.models.registry import build as build_model
from repro_torch.obs import trace as trace_mod
from repro_torch.serve import PagedEngine, Request
from repro_torch.tune.online import OnlineTuner

log = logging.getLogger("repro_torch.serve")


def random_requests(cfg, requests: int, max_new: int,
                    seed: int = 0) -> List[Request]:
    """``requests`` random prompts of 4..23 tokens drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    out = []
    for rid in range(requests):
        plen = int(rng.randint(4, 24))
        prompt = rng.randint(0, cfg.vocab, plen).astype(np.int64)
        out.append(Request(rid, prompt, max_new=max_new))
    return out


def serve(arch: str, *, smoke: bool = False, requests: int = 8,
          slots: int = 4, max_new: int = 16, block_size: int = 16,
          temperature: float = 0.0, backend: str = "auto", seed: int = 0,
          device: str = "cuda", params=None, online_tune: bool = False,
          trace=None, cfg=None) -> dict:
    """Serve ``requests`` random prompts (lengths 4..23, tokens from
    ``seed``) through :class:`PagedEngine`; returns the outputs and the
    run's counts and wall time.  ``params`` reuses the weights an earlier
    call returned; ``cfg`` serves that config in place of ``arch``'s (a
    depth cut, for one).  ``online_tune`` runs the small-budget online tuner
    between the engine's steps (its ``cycles`` and ``swaps`` are returned,
    and the tuner); ``trace`` writes the flight recorder's ring as a
    Perfetto JSON there (its path is returned)."""
    if cfg is None:
        cfg = configs.get_smoke(arch) if smoke else configs.get_config(arch)
    model = build_model(cfg)
    be = api.install(api.named_policy(backend))
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = model.init(gen, device)
    tuner = None
    if online_tune:
        # small budget: a short serve cycles often and times little, as
        # the reference's launcher does; it times where the engine runs
        tuner = OnlineTuner(interval_s=0.5, budget=4, top=1, reps=1,
                            device=device)
    engine = PagedEngine(model, params, be, slots=slots, max_len=256,
                         temperature=temperature, seed=seed,
                         block_size=block_size, tuner=tuner, device=device)
    t0 = time.perf_counter()
    for req in random_requests(cfg, requests, max_new, seed):
        engine.submit(req)
    done = engine.run()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    tokens = sum(len(v) for v in done.values())
    out = {"cfg": cfg, "params": params, "done": done, "tokens": tokens,
           "seconds": dt, "tok_s": tokens / dt,
           "decode_steps": engine._decode_steps,
           "steps_by_gen": dict(engine.steps_by_gen)}
    if tuner is not None:
        out.update(tuner=tuner, cycles=tuner.cycles, swaps=tuner.swaps)
    if trace:
        out["trace"] = trace_mod.write_trace(trace, slots=slots)
    return out


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--backend", default="auto",
                    choices=list(api.POLICY_NAMES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write the flight-recorder timeline as a "
                         "Chrome-trace/Perfetto JSON after the run")
    ap.add_argument("--online-tune", action="store_true",
                    help="run the traffic-aware re-tuner between the "
                         "engine's steps: hot size classes from "
                         "ROUTES.windowed() are re-timed on a budget and "
                         "merged into the live profile (kill switch: "
                         "REPRO_ONLINE_TUNE=0; pair with a routing "
                         "--backend — library sends the model's matmuls "
                         "past route(), so the tuner sees little traffic)")
    args = ap.parse_args()
    if configs.get_config(args.arch).family in encdec.FAMILIES:
        raise SystemExit("use a decoder-only arch for the serve demo")
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain versions)")
    r = serve(args.arch, smoke=args.smoke, requests=args.requests,
              slots=args.slots, max_new=args.max_new,
              block_size=args.block_size, temperature=args.temperature,
              backend=args.backend, seed=args.seed, device=args.device,
              online_tune=args.online_tune, trace=args.trace)
    for rid in sorted(r["done"]):
        log.info("req %d -> %d tokens: %s...", rid, len(r["done"][rid]),
                 r["done"][rid][:8])
    print(f"served {len(r['done'])} requests, {r['tokens']} tokens in "
          f"{r['seconds']:.2f}s ({r['tok_s']:.1f} tok/s) on {args.device}")
    if args.online_tune:
        print(f"online tuner: {r['cycles']} cycles, {r['swaps']} profile "
              "swaps")
    if args.trace:
        print(f"trace: {r['trace']} ({len(trace_mod.TRACE)} events, "
              f"{trace_mod.TRACE.dropped} dropped; open in "
              f"https://ui.perfetto.dev)")


if __name__ == "__main__":
    main()
