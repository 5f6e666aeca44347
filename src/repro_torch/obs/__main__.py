"""CLI for the port's observability layer (counterpart of ``repro.obs``'s).

    python -m repro_torch.obs                 # summarize BENCH_*.json files
    python -m repro_torch.obs ls              # same ("list" also works)
    python -m repro_torch.obs show BENCH_x.json
    python -m repro_torch.obs diff OLD NEW    # metric deltas between two
    python -m repro_torch.obs report          # live registry of this process
    python -m repro_torch.obs trace OUT.json  # live flight recorder -> Perfetto
    python -m repro_torch.obs trace IN OUT.json   # re-export a --trace dump

``ls`` lists :func:`repro_torch.obs.bench_root` (``build/repro_torch/
bench/`` in the checkout, or ``$REPRO_TORCH_BENCH_DIR``).  ``diff`` exits
0 always: the numbers are for humans.

``trace`` writes a Chrome-trace-event JSON (open in
https://ui.perfetto.dev or ``chrome://tracing``): slots as tracks,
requests as flow-connected queued→prefill→decode slices, the online
tuner's cycles on their own track.  With one path it dumps this process's
live ring; with two it re-derives the view from a file written by
``python -m repro_torch.launch.serve --trace`` (the raw events ride
inside it), printing the per-request metrics either way.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

from repro_torch import obs
from repro_torch.obs import trace as trace_mod


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.4g}" if isinstance(v, float) else str(v)


def _show(path: pathlib.Path) -> None:
    doc = obs.load_bench(path)
    print(f"== {path.name} (bench={doc['bench']}, "
          f"schema={doc['schema']}) ==")
    meta = doc.get("meta", {})
    if meta:
        print("  meta: " + ", ".join(f"{k}={v}" for k, v in
                                     sorted(meta.items())))
    for key, val in sorted(obs._scalar_metrics(doc).items()):
        print(f"  {key:<52s} {_fmt(val)}")
    rows = doc.get("router", [])
    if rows:
        print(f"  -- router shape histogram ({len(rows)} classes) --")
        for r in rows[:15]:
            print(f"  {r['op']:<13s} {r['dtype']}/{r['trans']} "
                  f"class={r['size_class']:<10s} {r['source']:<10s} "
                  f"x{r['count']}")


def _diff(old: pathlib.Path, new: pathlib.Path) -> None:
    a, b = obs.load_bench(old), obs.load_bench(new)
    print(f"== diff {old.name} -> {new.name} ==")
    print(f"{'metric':<52s} {'old':>12s} {'new':>12s} {'change':>9s}")
    for key, va, vb, pct in obs.diff_bench(a, b):
        change = f"{pct:+.1f}%" if pct is not None else "-"
        print(f"{key:<52s} {_fmt(va):>12s} {_fmt(vb):>12s} {change:>9s}")


_TRACE_COLS = ("queue_wait_us", "ttft_wait_us", "ttft_prefill_us",
               "decode_stall_us", "preemptions", "n_out")


def _print_per_request(per: dict) -> None:
    if not per:
        print("(no request events in the trace)")
        return
    print(f"{'rid':>5s} " + " ".join(f"{c:>16s}" for c in _TRACE_COLS))
    for rid in sorted(per):
        r = per[rid]
        print(f"{rid:>5d} " + " ".join(
            f"{_fmt(r.get(c)):>16s}" for c in _TRACE_COLS))


def _trace(files) -> int:
    if len(files) == 1:                      # live ring of this process
        events = obs.TRACE.snapshot()
        out = pathlib.Path(files[0])
        if not events:
            print("live flight recorder is empty (tracing happens in the "
                  "serving process; convert a --trace dump with: "
                  "python -m repro_torch.obs trace IN.json OUT.json)")
    elif len(files) == 2:                    # re-export a --trace dump
        events = trace_mod.load_events(files[0])
        out = pathlib.Path(files[1])
    else:
        return -1
    path = trace_mod.write_trace(out, events)
    _print_per_request(trace_mod.per_request(events))
    print(f"wrote {path} ({len(events)} events; open in "
          f"https://ui.perfetto.dev)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("cmd", nargs="?", default="list",
                    choices=["list", "ls", "show", "diff", "report",
                             "trace"])
    ap.add_argument("files", nargs="*",
                    help="BENCH_*.json path(s); for trace: [IN] OUT")
    args = ap.parse_args(argv)

    if args.cmd == "report":
        print(obs.report_str())
        return 0
    if args.cmd == "show":
        if len(args.files) != 1:
            ap.error("show takes exactly one BENCH file")
        _show(pathlib.Path(args.files[0]))
        return 0
    if args.cmd == "diff":
        if len(args.files) != 2:
            ap.error("diff takes exactly two BENCH files: OLD NEW")
        _diff(pathlib.Path(args.files[0]), pathlib.Path(args.files[1]))
        return 0
    if args.cmd == "trace":
        if _trace(args.files) != 0:
            ap.error("trace takes OUT.json (live ring) or IN.json OUT.json "
                     "(re-export a dump)")
        return 0
    found = sorted(obs.bench_root().glob("BENCH_*.json"))
    if not found:
        print(f"no BENCH_*.json under {obs.bench_root()} — write one with "
              f"repro_torch.obs.export_bench(name)")
        return 0
    for p in found:
        _show(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
