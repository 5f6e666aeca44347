"""Serving launcher: paged continuous-batched generation on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
        --backend auto --requests 6 --max-new 16

Counterpart of ``repro/launch/serve.py``, with the same flags plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).  Weights are random, drawn from ``--seed`` by a
``torch.Generator`` on the device.  ``--online-tune`` and ``--trace`` are
not ported yet.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch import api, configs
from repro_torch.models.registry import build as build_model
from repro_torch.serve import PagedEngine, Request

log = logging.getLogger("repro_torch.serve")


def serve(arch: str, *, smoke: bool = False, requests: int = 8,
          slots: int = 4, max_new: int = 16, block_size: int = 16,
          temperature: float = 0.0, backend: str = "auto", seed: int = 0,
          device: str = "cuda", params=None) -> dict:
    """Serve ``requests`` random prompts (lengths 4..23, tokens from
    ``seed``) through :class:`PagedEngine`; returns the outputs and the
    run's counts and wall time.  ``params`` reuses the weights an earlier
    call returned."""
    cfg = configs.get_smoke(arch) if smoke else configs.get_config(arch)
    model = build_model(cfg)
    be = api.install(api.named_policy(backend))
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = model.init(gen, device)
    engine = PagedEngine(model, params, be, slots=slots, max_len=256,
                         temperature=temperature, seed=seed,
                         block_size=block_size, device=device)
    rng = np.random.RandomState(seed)
    t0 = time.perf_counter()
    for rid in range(requests):
        plen = int(rng.randint(4, 24))
        prompt = rng.randint(0, cfg.vocab, plen).astype(np.int64)
        engine.submit(Request(rid, prompt, max_new=max_new))
    done = engine.run()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    tokens = sum(len(v) for v in done.values())
    return {"cfg": cfg, "params": params, "done": done, "tokens": tokens,
            "seconds": dt, "tok_s": tokens / dt,
            "decode_steps": engine._decode_steps}


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
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain versions)")
    r = serve(args.arch, smoke=args.smoke, requests=args.requests,
              slots=args.slots, max_new=args.max_new,
              block_size=args.block_size, temperature=args.temperature,
              backend=args.backend, seed=args.seed, device=args.device)
    for rid in sorted(r["done"]):
        log.info("req %d -> %d tokens: %s...", rid, len(r["done"][rid]),
                 r["done"][rid][:8])
    print(f"served {len(r['done'])} requests, {r['tokens']} tokens in "
          f"{r['seconds']:.2f}s ({r['tok_s']:.1f} tok/s) on {args.device}")


if __name__ == "__main__":
    main()
