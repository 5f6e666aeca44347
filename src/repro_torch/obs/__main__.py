"""CLI for the port's observability layer (counterpart of ``repro.obs``'s).

    python -m repro_torch.obs                 # live registry (as "report")
    python -m repro_torch.obs report          # live registry of this process
    python -m repro_torch.obs trace OUT.json  # live flight recorder -> Perfetto
    python -m repro_torch.obs trace IN OUT.json   # re-export a --trace dump

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
    ap.add_argument("cmd", nargs="?", default="report",
                    choices=["report", "trace"])
    ap.add_argument("files", nargs="*", help="for trace: [IN] OUT")
    args = ap.parse_args(argv)

    if args.cmd == "trace":
        if _trace(args.files) != 0:
            ap.error("trace takes OUT.json (live ring) or IN.json OUT.json "
                     "(re-export a dump)")
        return 0
    if args.files:
        ap.error("report takes no files")
    print(obs.report_str())
    return 0


if __name__ == "__main__":
    sys.exit(main())
