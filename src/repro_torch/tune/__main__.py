"""``python -m repro_torch.tune`` — run the empirical install-time sweep.

Examples::

    python -m repro_torch.tune --letters SDCZ --trans NN,NT,TN,TT --quick
    python -m repro_torch.tune --letters C --trans NN --quick --device cpu
    python -m repro_torch.tune --show        # print the profile, no sweep

Times on the card by default (``--device cuda``: the CUDA kernels against
cuBLAS, with CUDA events); ``--device cpu`` times the plain versions with
the host clock and writes a ``cpu`` profile, which never applies on the
card.  Writes the versioned DeviceProfile JSON to the per-device default
path (override with ``--out`` or ``$REPRO_TORCH_TUNE_CACHE``) and merges
with an existing profile there unless ``--no-merge``.  The reference's
``--compiled`` flag has no counterpart: the device decides what is timed.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from repro_torch.tune import classes as classes_mod
from repro_torch.tune import profile as profile_mod
from repro_torch.tune import search


def _parse_letters(s: str):
    letters = [c for c in s.upper().replace(",", "") if not c.isspace()]
    for c in letters:
        if c not in ("S", "D", "C", "Z", "H"):
            raise argparse.ArgumentTypeError(f"unknown BLAS letter {c!r}")
    return letters


def _parse_trans(s: str):
    out = [t.strip().upper() for t in s.split(",") if t.strip()]
    for t in out:
        if t not in ("NN", "NT", "TN", "TT"):
            raise argparse.ArgumentTypeError(f"unknown transposition {t!r}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="Empirical IAAT tuning sweep -> persistent DeviceProfile")
    ap.add_argument("--letters", type=_parse_letters, default=["S"],
                    help="BLAS dtype letters, e.g. S, SDCZ, S,D (default S)")
    ap.add_argument("--trans", type=_parse_trans, default=["NN"],
                    help="comma-separated transpositions (default NN)")
    ap.add_argument("--min-dim", type=int, default=8)
    ap.add_argument("--max-dim", type=int, default=512)
    ap.add_argument("--top", type=int, default=4,
                    help="candidates timed per class after the prior prune")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--quick", action="store_true",
                    help="cube classes only, max-dim 128, reps 3, top 2")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="what to time: the CUDA kernels on the card "
                         "(default) or the plain versions on the CPU")
    ap.add_argument("--out", default=None,
                    help="profile path (default: per-device cache path)")
    ap.add_argument("--no-merge", action="store_true",
                    help="overwrite instead of merging an existing profile")
    ap.add_argument("--show", action="store_true",
                    help="print the profile at the target path and exit")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: tune on the card, or pass --device cpu",
              file=sys.stderr)
        return 2
    path = args.out or profile_mod.default_profile_path(
        profile_mod.device_kind_of(args.device), args.device)
    if args.show:
        try:
            prof = profile_mod.DeviceProfile.load(path)
        except (OSError, ValueError, KeyError) as e:
            print(f"no profile at {path}: {e}", file=sys.stderr)
            return 1
        print(json.dumps(prof.to_json(), indent=1, sort_keys=True))
        return 0

    if args.quick:
        args.max_dim = min(args.max_dim, 128)
        args.reps = min(args.reps, 3)
        args.top = min(args.top, 2)

    def progress(sc, entry):
        winner = "kernel" if entry.prefer_kernel else "library"
        sig = entry.sig.name if entry.sig else "-"
        ker = f"{entry.kernel.median_us:9.1f}" if entry.kernel else "     fail"
        lib = f"{entry.library.median_us:9.1f}" if entry.library else \
            "     fail"
        print(f"  {sc.key:<18} kernel {ker}us  library {lib}us  "
              f"-> {winner:<7} {sig}")

    n_classes = len(classes_mod.classes_up_to(
        args.letters, args.trans, args.max_dim, min_dim=args.min_dim,
        cube_only=args.quick))
    print(f"tuning {n_classes} size classes "
          f"({''.join(args.letters)} x {','.join(args.trans)}, "
          f"dims {args.min_dim}..{args.max_dim}, on {args.device})")
    prof = search.sweep(args.letters, args.trans,
                        min_dim=args.min_dim, max_dim=args.max_dim,
                        cube_only=args.quick, top=args.top,
                        warmup=args.warmup, reps=args.reps,
                        device=args.device, progress=progress)
    if not args.no_merge:
        try:
            prof = profile_mod.DeviceProfile.load(path).merge(prof)
        except (OSError, ValueError, KeyError):
            pass        # absent or unusable existing profile: overwrite
    written = prof.save(path)
    profile_mod.clear_active_profile()   # the next tuned routing re-reads
    n_kernel = sum(e.prefer_kernel for e in prof.entries.values())
    print(f"wrote {written} ({len(prof)} classes, "
          f"{n_kernel} prefer the kernel)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
