"""Compare two checkouts of the port on one NVIDIA GPU, in turns.

    python3 chip_compare.py OLD_ROOT NEW_ROOT [--out FILE]

Each root is a checkout (its ``src/repro_torch`` is imported in a
subprocess of its own, which builds that tree's kernels).  The runs go
old, new, new, old, so that a drift of the card shows as a difference
between the two runs of one tree.  Each run times, with CUDA events
(loop time, host launch time included) and torch.profiler (device time
of the kernel):

* the flash kernel at the wave's prefill shape (B 4 x 16 heads x S 23 x
  D 128, bf16, causal) and at B 1 x 16 x S 2048 x D 128;
* one olmo-1b decode step's routed GEMMs at M = 4 under the forced
  kernel (per layer q, k, v, o, gate, up, down on their own weights, then
  the tied unembed: 113 ``api.matmul`` calls, 2.3 GB of weights);
* the grouped kernels at moonshot-v1-16b-a3b's decode shapes, bf16:
  ``batched_gemm`` on 64 experts x C 8 for gate/up (K 2048, N 1408) and
  down (K 1408, N 2048), and ``ragged_gemm`` (the wrapper's launch alone)
  on the dropless layout of 4 tokens x top-6 in row tiles of 8, each with
  its library call beside it (``torch.bmm``, ``torch._grouped_mm``);
* the complex kernel through ``api.gemm`` under the forced kernel, C
  (complex64) and Z (complex128) at 80^3, 512^3 and 2048^3, NN;
* the SSD scan at mamba2-780m's ``forward_train`` shape (Bt 2 x S 2048 x
  48 heads x P 64, N 128, chunk 128, f32).

Prints one line per run and the card's name and power limit, and writes
the runs to ``--out`` (default ``chiprun_out/chip_compare.json``).  Exits
non-zero without CUDA or when a run fails.
"""
import argparse
import json
import os
import pathlib
import subprocess
import sys

RUN = r'''
import json, math, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch import api
from repro_torch.kernels import build, flash_attention as fa

build.load()
torch.backends.cuda.matmul.allow_tf32 = False
g = torch.Generator(device="cuda").manual_seed(0)


def loop_ms(fn, n, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def device_ms(fn, n, match):
    """Device ms a call of fn's kernels whose name holds match, from a
    torch.profiler trace of n calls; a trace that comes back without
    device events, or with a count of them that is no whole number a
    call (kernels lost while it started), is taken again (three tries,
    then None)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if match in e.key and str(e.device_type).endswith("CUDA")
                 and e.self_device_time_total > 0]
        count = sum(e.count for e in found)
        if count and count % n == 0:
            return sum(e.self_device_time_total for e in found) / 1e3 / n
    return None


def both(fn, match, n=20):
    return {"loop_ms": loop_ms(fn, n), "device_ms": device_ms(fn, 10, match)}


out = {}
for B, H, S, D in ((4, 16, 23, 128), (1, 16, 2048, 128)):
    q, k, v = (torch.randn((B, H, S, D), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    f = lambda: fa.flash_attention(q, k, v)
    out[f"flash B{B} x {H} x S{S} x D{D}"] = {
        "loop_ms": loop_ms(f, 50 if S < 1024 else 10),
        "device_ms": device_ms(f, 10, "flash_attention")}
kern = api.Policy(backend="kernel")
d, ff, vocab = 2048, 8192, 50432


def weight(k, n):
    return (torch.randn((k, n), generator=g, device="cuda") /
            math.sqrt(k)).to(torch.bfloat16)


x = torch.randn((4, d), generator=g, device="cuda").to(torch.bfloat16)
xf = torch.randn((4, ff), generator=g, device="cuda").to(torch.bfloat16)
calls = []
for _ in range(16):
    calls += [(x, weight(d, d)) for _ in range(4)]
    calls += [(x, weight(d, ff)) for _ in range(2)] + [(xf, weight(ff, d))]
calls.append((x, weight(vocab, d).T))


def step():
    for a, b in calls:
        api.matmul(a, b, policy=kern)


out["olmo-1b decode step GEMMs, M 4"] = {
    "loop_ms": loop_ms(step, 3, 1),
    "device_ms": device_ms(step, 1, "iaat_gemm_kernel")}
del calls

from repro_torch.kernels import grouped_gemm as gg
# moonshot-v1-16b-a3b decode: 64 experts, capacity 8 rows for 4 slots x
# top-6, d_model 2048, d_expert 1408; the ragged rows of the same 4
# tokens, each expert's rows padded to one tile of 8
E, C, top_k = 64, 8, 6
gen = torch.Generator().manual_seed(5)
counts = [0] * E
for _ in range(4):
    for e in torch.randperm(E, generator=gen)[:top_k].tolist():
        counts[e] += 1
ids = torch.tensor([e for e, c in enumerate(counts) if c], dtype=torch.int32,
                   device="cuda")
T = 8 * ids.numel()
for (K, N) in ((2048, 1408), (1408, 2048)):
    x = torch.randn((E, C, K), generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn((E, K, N), generator=g, device="cuda") /
         math.sqrt(K)).to(torch.bfloat16)
    xr = torch.randn((T, K), generator=g, device="cuda").to(torch.bfloat16)
    offs = (torch.bincount(ids.long(), minlength=E).cumsum(0) * 8).to(
        torch.int32)
    blocks = gg.pick_blocks(C, K, N, torch.bfloat16)
    rblocks = gg.pick_blocks(8, K, N, torch.bfloat16)
    out[f"batched_gemm 64 x 8 K{K} N{N}"] = both(
        lambda: gg.batched_gemm(x, w, blocks=blocks), "gemm_kernel")
    out[f"torch.bmm 64 x 8 K{K} N{N}"] = both(lambda: torch.bmm(x, w), "")
    out[f"ragged_gemm {T} rows K{K} N{N}"] = both(
        lambda: gg._launch_ragged(xr, w, ids, 8, rblocks), "gemm_kernel")
    try:
        out[f"torch._grouped_mm {T} rows K{K} N{N}"] = both(
            lambda: torch._grouped_mm(xr, w, offs=offs), "")
    except RuntimeError as e:      # a yardstick, not a check: say why
        out[f"torch._grouped_mm {T} rows K{K} N{N}"] = str(e)[:200]
from repro_torch.kernels import ssd
for letter, dt in (("C", torch.complex64), ("Z", torch.complex128)):
    for n in (80, 512, 2048):
        a, b = (torch.complex(torch.randn((n, n), generator=g, device="cuda",
                                          dtype=torch.float64),
                              torch.randn((n, n), generator=g, device="cuda",
                                          dtype=torch.float64)).to(dt)
                for _ in range(2))
        out[f"cx_gemm {letter} {n}^3"] = both(
            lambda: api.gemm(a, b, policy=kern), "cx_gemm",
            50 if n < 1024 else 10)
Bt, S, H, P, N = 2, 2048, 48, 64, 128
row = torch.randn((Bt, S, H * P + 2 * N), generator=g, device="cuda") * 0.3
x = row[..., :H * P].reshape(Bt, S, H, P)
B = row[..., H * P:H * P + N].reshape(Bt, S, 1, N)
C = row[..., H * P + N:].reshape(Bt, S, 1, N)
dt = torch.randn((Bt, S, H), generator=g, device="cuda").abs() * 0.1 + 0.01
A = -torch.randn((H,), generator=g, device="cuda").abs() * 0.5 - 0.1
out["ssd_scan 2 x 2048 x 48 x 64, N 128, chunk 128"] = both(
    lambda: ssd.ssd_scan(x, dt, A, B, C, chunk=128), "ssd_")
print("RESULT " + json.dumps(out))
'''


def run_tree(root):
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run([sys.executable, "-c", RUN], cwd=root, env=env,
                         capture_output=True, text=True, timeout=1200)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    if res.returncode or not line:
        raise RuntimeError(f"run in {root} failed:\n{res.stdout[-3000:]}\n"
                           f"{res.stderr[-3000:]}")
    return json.loads(line[0][len("RESULT "):])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=pathlib.Path)
    ap.add_argument("new", type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("chiprun_out/chip_compare.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    runs = []
    for name in ("old", "new", "new", "old"):
        root = getattr(args, name).resolve()
        r = run_tree(root)
        runs.append({"tree": name, "root": str(root), **r})
        print(name, json.dumps(r), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
