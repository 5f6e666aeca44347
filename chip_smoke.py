"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout; builds the port's CUDA kernels from the
sources there (into build/repro_torch/), then, in phases, each of which
fails the run:

1. card   — prints ``nvidia-smi --query-gpu=name,power.limit`` as is;
2. build  — compiles every instance of the IAAT GEMM kernel table;
3. check  — the CUDA IAAT kernel against its plain PyTorch version, on
            the card, for S/H/D x NN/NT/TN/TT, K tails, M/N overhangs,
            alpha/beta with and without C, and olmo-1b's main-path shapes;
4. serve  — olmo-1b at full width and full depth (16 layers, bf16, random
            weights from a seeded torch.Generator) serves 6 requests
            through PagedEngine (after an uncounted one-request warm-up),
            once under the ``auto`` policy and once with every routed GEMM
            forced onto the kernel; the kernel's launch count must be > 0
            under both;
5. step   — one full-width paged_decode step through the kernel and
            through the plain arithmetic (the library route computes
            exactly gemm_region_plain's contract + epilogue), logits
            compared;
6. kernels — times at the main-path shapes, printed as the ``kernels``
            JSON line.

The last line is {"ok": true, "device": {...}}; it is printed only when
every phase passed.  Without CUDA, or without the repository around it,
the script exits non-zero and prints no result.
"""
import json
import math
import pathlib
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

#: kernel-vs-plain tolerance on max|kernel - plain| / max|plain|: the two
#: take the same exact products and f32 (S, H) / f64 (D) sums in other
#: orders; H outputs are bf16, where one rounding step is 2^-8 relative
TOL = {"S": 1e-5, "D": 1e-12, "H": 8e-3}
#: full-width decode step, kernel vs plain arithmetic: every projection
#: rounds to bf16 and a one-step rounding flip in one of 16 layers
#: propagates; held to 5% of the largest logit
STEP_TOL = 5e-2


def log(msg):
    print(msg, flush=True)


def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(out, flush=True)
    return out


def phase_build():
    from repro_torch.core import kernelgen
    from repro_torch.kernels import build
    import re
    t0 = time.perf_counter()
    n = kernelgen.install()
    lib = build.build()         # already built: returns its path
    ptx = (lib.parent / "ptxas.log").read_text()
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", ptx)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", ptx))
    log(f"build: {n} instances in "
        f"{time.perf_counter() - t0:.1f}s, {len(regs)} kernels, max "
        f"{max(regs)} registers, {spills} bytes spill stores -> {lib}")
    if len(regs) != len(kernelgen.instances()):
        raise RuntimeError("ptxas reported another kernel count than the "
                           "table's instances")


def _rel_err(got, want):
    d = (got.double() - want.double()).abs().max().item()
    return d, d / max(want.double().abs().max().item(), 1e-30)


def phase_check(torch):
    from repro_torch import api
    from repro_torch.core import kernelgen
    from repro_torch.kernels import iaat_gemm
    g = torch.Generator(device="cuda").manual_seed(1)
    dt = {"S": torch.float32, "D": torch.float64, "H": torch.bfloat16}
    kern = api.Policy(backend="kernel")
    worst = {}
    for letter in ("S", "H", "D"):
        for trans in ("NN", "NT", "TN", "TT"):
            sig = kernelgen.kernel_table(letter, trans)[0]
            for (M, N, K) in ((30, 50, 21), (1, 1, 1), (129, 257, 70),
                              (33, 300, 130), (4, 2048, 2048)):
                a = torch.randn((M, K) if trans[0] == "N" else (K, M),
                                generator=g, device="cuda").to(dt[letter])
                b = torch.randn((K, N) if trans[1] == "N" else (N, K),
                                generator=g, device="cuda").to(dt[letter])
                c = torch.randn((M, N), generator=g,
                                device="cuda").to(dt[letter])
                for cc, al, be in ((None, 1.0, 0.0), (c, -0.75, 2.5)):
                    out = api.gemm(a, b, cc, al, be, trans[0] == "T",
                                   trans[1] == "T", policy=kern)
                    want = iaat_gemm.gemm_region_plain(sig, a, b, cc, al, be)
                    torch.cuda.synchronize()
                    _, rel = _rel_err(out, want)
                    key = f"{letter}{trans}"
                    worst[key] = max(worst.get(key, 0.0), rel)
                    if not rel <= TOL[letter]:
                        raise AssertionError(
                            f"{letter} {trans} {M}x{N}x{K} c={cc is not None}"
                            f": rel err {rel} > {TOL[letter]}")
    log("check: worst rel err per letter/trans (tol S 1e-5, H 8e-3, D "
        "1e-12): " + json.dumps({k: float(f"{v:.3g}") for k, v in
                                 worst.items()}))
    main = {}
    for M in (4, 32):
        for (K, N, tied) in MAIN_SHAPES:
            x, (w,) = _main_operands(torch, g, M, K, N, tied)
            out = api.matmul(x, w, policy=kern)
            want = iaat_gemm.gemm_region_plain(
                kernelgen.kernel_table("H", "NN")[0], x, w)
            torch.cuda.synchronize()
            ab, rel = _rel_err(out, want)
            main[(M, K, N, tied)] = ab
            log(f"check main path H M={M} K={K} N={N} tied={tied}: max abs "
                f"err {ab:.4g}, rel {rel:.3g} (tol {TOL['H']})")
            if not rel <= TOL["H"]:
                raise AssertionError(f"main-path shape {M}x{N}x{K}: {rel}")
    return max(main.values())


#: (K, N, tied) of olmo-1b's routed GEMMs: q/k/v/o, gate/up, down, and the
#: tied unembed against the padded vocab (filled in from the config)
MAIN_SHAPES = []


def _main_operands(torch, g, M, K, N, tied, copies=1):
    """x (M, K) and ``copies`` bf16 weights (K, N); a tied weight is the
    .T view of an (N, K) embedding."""
    x = (torch.randn((M, K), generator=g, device="cuda")).to(torch.bfloat16)
    ws = []
    for _ in range(copies):
        # scaled as the model's weights are (1/sqrt(d_in) for projections,
        # d**-0.5 for the embedding, the same value here)
        if tied:     # embed (N, K) read through its .T view
            w = (torch.randn((N, K), generator=g, device="cuda") /
                 math.sqrt(K)).to(torch.bfloat16).T
        else:
            w = (torch.randn((K, N), generator=g, device="cuda") /
                 math.sqrt(K)).to(torch.bfloat16)
        ws.append(w)
    return x, ws


def phase_serve(torch, cfg):
    from repro_torch import obs
    from repro_torch.kernels import iaat_gemm
    from repro_torch.launch import serve as serve_mod
    runs = {}
    # warm-up, not counted: weights, cuBLAS and allocator set-up, first
    # launches
    params = serve_mod.serve("olmo-1b", requests=1, max_new=2, backend="auto",
                             seed=0, device="cuda")["params"]
    for backend in ("auto", "kernel"):
        obs.ROUTES.reset()
        iaat_gemm.reset_launch_count()
        r = serve_mod.serve("olmo-1b", requests=6, slots=4, max_new=16,
                            block_size=16, backend=backend, seed=0,
                            device="cuda", params=params)
        launches = iaat_gemm.launch_count()
        to_kernel, routed = obs.ROUTES.kernel_share()
        params = r["params"]
        done = r["done"]
        if sorted(done) != list(range(6)):
            raise AssertionError(f"served {sorted(done)}, want 6 requests")
        for rid, toks in done.items():
            if not 1 <= len(toks) <= 16 or not all(
                    0 <= t < cfg.vocab_padded for t in toks):
                raise AssertionError(f"request {rid}: bad tokens {toks}")
        if launches <= 0:
            raise AssertionError(f"{backend}: the IAAT kernel never ran")
        runs[backend] = {"tokens": r["tokens"], "seconds": r["seconds"],
                         "tok_s": r["tok_s"], "launches": launches,
                         "decode_steps": r["decode_steps"],
                         "routed": routed, "to_kernel": to_kernel,
                         "launches_per_token": launches / r["tokens"]}
        log(f"serve[{backend}]: {r['tokens']} tokens in {r['seconds']:.3f}s "
            f"= {r['tok_s']:.1f} tok/s, kernel launches {launches} "
            f"({launches / r['tokens']:.1f}/token), routed GEMMs to the "
            f"kernel {to_kernel}/{routed} = {to_kernel / routed:.3f}")
        runs[backend]["done"] = done
    same = sum(runs["auto"]["done"][i] == runs["kernel"]["done"][i]
               for i in range(6))
    log(f"serve: {same}/6 requests token-identical between auto and kernel")
    for v in runs.values():
        v.pop("done")
    return runs, params


def phase_step(torch, cfg, params):
    """One decode step over 4 slots after a prefill of each, through the
    kernel and through the plain arithmetic, on identical pool copies."""
    import copy
    from repro_torch import api
    from repro_torch.models import lm
    kern, plain = api.Policy(backend="kernel"), api.Policy(backend="library")
    BS, slots, nmax = 16, 4, 4
    ps = lm.init_paged_state(cfg, 1 + slots * nmax, BS, slots,
                             cfg.compute_dtype, "cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    tables = torch.arange(1, 1 + slots * nmax, device="cuda").reshape(
        slots, nmax)
    lens = [5, 12, 20, 9]
    with torch.no_grad():
        for s, n in enumerate(lens):
            toks = torch.randint(0, cfg.vocab, (1, 32), generator=g,
                                 device="cuda")
            lm.paged_prefill(params, cfg, kern, toks, ps, tables[s:s + 1],
                             torch.zeros(1, dtype=torch.long, device="cuda"),
                             n)
        cur = torch.randint(0, cfg.vocab, (slots, 1), generator=g,
                            device="cuda")
        pos = torch.tensor(lens, device="cuda")
        ps2 = copy.deepcopy(ps)
        lk = lm.paged_decode(params, cfg, kern, cur, ps, tables, pos)
        lp = lm.paged_decode(params, cfg, plain, cur, ps2, tables, pos)
        torch.cuda.synchronize()
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError("non-finite logits")
    if tuple(lk.shape) != (slots, 1, cfg.vocab_padded):
        raise AssertionError(f"logits shape {tuple(lk.shape)}")
    ab, rel = _rel_err(lk, lp)
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    log(f"step: full-width paged_decode kernel vs plain: max abs err "
        f"{ab:.4g}, rel {rel:.3g} (tol {STEP_TOL}), argmax agreement "
        f"{agree:.2f}")
    if not rel <= STEP_TOL:
        raise AssertionError(f"decode step rel err {rel} > {STEP_TOL}")
    return {"max_abs_err": ab, "rel_err": rel, "argmax_agree": agree}


def _time_ms(torch, fn, n_rep, warm=3):
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(n_rep):
        fn(i)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n_rep


def phase_kernels(torch, cfg, launches, max_abs_err):
    """Kernel / plain / library times and the bound at every main-path
    shape, each weight cycled through enough copies (> 2 x the 50 MB L2)
    that every call reads it from HBM as the decode step does.  The line's
    numbers are one olmo-1b decode step's routed GEMMs at M=4 (the 7
    projections x 16 layers, plus the tied unembed), summed."""
    from repro_torch import api
    from repro_torch.core import cost, kernelgen
    from repro_torch.kernels import iaat_gemm
    kern = api.Policy(backend="kernel")
    sig = kernelgen.kernel_table("H", "NN")[0]
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for M in (4, 32):
        for (K, N, tied) in MAIN_SHAPES:
            wbytes = K * N * 2
            copies = max(1, math.ceil(110e6 / wbytes))
            x, ws = _main_operands(torch, g, M, K, N, tied, copies=copies)
            n = len(ws)
            reps = max(20, 2 * n)
            t_k = _time_ms(torch, lambda i: api.matmul(x, ws[i % n],
                                                       policy=kern), reps)
            t_p = _time_ms(torch, lambda i: iaat_gemm.gemm_region_plain(
                sig, x, ws[i % n]), reps)
            t_l = _time_ms(torch, lambda i: torch.matmul(x, ws[i % n]), reps)
            bound = cost.gemm_roofline(M, N, K, "H")
            rows.append({"M": M, "K": K, "N": N, "tied": tied,
                         "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                         "bound_ms": bound.seconds * 1e3,
                         "bound_by": bound.bound})
            log(f"kernel time H M={M} K={K} N={N} tied={tied}: kernel "
                f"{t_k:.4f} ms, plain {t_p:.4f} ms, library {t_l:.4f} ms, "
                f"bound {bound.seconds * 1e3:.4f} ms ({bound.bound})")
    # one decode step at M=4: per layer q,k,v,o (2048x2048), gate, up
    # (2048x8192), down (8192x2048); then the tied unembed
    per_layer = {(cfg.d_model, cfg.d_model, False): 4,
                 (cfg.d_model, cfg.d_ff, False): 2,
                 (cfg.d_ff, cfg.d_model, False): 1}
    mix = {k: v * cfg.n_layers for k, v in per_layer.items()}
    mix[(cfg.d_model, cfg.vocab_padded, True)] = 1
    step = {k: 0.0 for k in ("ms", "plain_ms", "library_ms")}
    flops = nbytes = 0
    for r in rows:
        cnt = mix.get((r["K"], r["N"], r["tied"]), 0) if r["M"] == 4 else 0
        for k in step:
            step[k] += cnt * r[k]
        if cnt:
            b = cost.gemm_roofline(4, r["N"], r["K"], "H")
            flops += cnt * b.flops
            nbytes += cnt * b.hbm_bytes
    bound_s = max(flops / cost.PEAK_FLOPS_BF16, nbytes / cost.HBM_BW)
    entry = {
        "name": "iaat_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/iaat_gemm.cu",
        "replaces": "src/repro/kernels/iaat_gemm.py:88",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": step["ms"],
        "plain_ms": step["plain_ms"],
        "bound_ms": bound_s * 1e3,
        "bound_by": "bytes" if nbytes / cost.HBM_BW >= flops /
        cost.PEAK_FLOPS_BF16 else "operations",
        "library_ms": step["library_ms"],
        "at": "one olmo-1b decode step's routed GEMMs, M=4, bf16, summed",
    }
    return entry, rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))
    from repro_torch import configs
    cfg = configs.get_config("olmo-1b")
    MAIN_SHAPES[:] = [(cfg.d_model, cfg.d_model, False),
                      (cfg.d_model, cfg.d_ff, False),
                      (cfg.d_ff, cfg.d_model, False),
                      (cfg.d_model, cfg.vocab_padded, True)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)}
    try:
        report["card"] = phase_card()
        phase_build()
        max_err = phase_check(torch)
        report["serve"], params = phase_serve(torch, cfg)
        report["step"] = phase_step(torch, cfg, params)
        del params
        torch.cuda.empty_cache()
        entry, rows = phase_kernels(torch, cfg,
                                    report["serve"]["auto"]["launches"],
                                    max_err)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    report["kernels"] = [entry]
    report["shapes"] = rows
    report["seconds"] = time.perf_counter() - t_start
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"chip_smoke: all phases passed in {report['seconds']:.1f}s")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
