"""Readings that set a cell's correctness limits, not a benchmark run:
the program's numbers and the control's (the plain reference in the
precision below the configuration's) over many seeds in one process.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> --seeds 1 2 3 [--control]

Prints one JSON line a seed.  With ``--control`` the reference in fp8
stands in the program's place and ``correct`` is judged on its numbers
(the program's own stay under ``gaps``).  The benchmark's own runs never
run the control.
"""
import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default="",
                   help="a fault of perfbench/faults.py to plant")
    args = p.parse_args()
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from perfbench import spec
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    doc = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])
    if mix["kind"] == "serve":
        from perfbench import serve as kind
    else:
        from perfbench import train as kind
    if args.fault:
        from perfbench import faults
        kinds = faults.SERVE if mix["kind"] == "serve" else faults.TRAIN
        kinds[args.fault](setattr)
    for seed in args.seeds:
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        res = kind.run(doc, mix, limits, seed, args.seconds, False,
                         device="cuda", control=args.control)
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": res["correct"],
                          "checks": res["checks"],
                          "e2e": res["e2e"], "gaps": res.get("gaps"),
                          "control": res.get("control"),
                          "served_tokens": res.get("served_tokens"),
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "peak": res["memory_peak_bytes"],
                          "ctx_steps": res["ctx"]["steps"],
                          "seconds": time.perf_counter() - t}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
