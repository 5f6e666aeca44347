"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout; builds the port's CUDA kernels from the
sources there (into build/repro_torch/), then, in phases, each of which
fails the run:

1. card   — prints ``nvidia-smi --query-gpu=name,power.limit`` as is;
2. build  — compiles every instance of the kernel table, for the IAAT
            GEMM and the two grouped kernels (S/D/H), the complex
            Karatsuba kernel (C/Z), and the flash attention instances
            (ptxas must report all);
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
6. grouped check — the CUDA batched and ragged grouped kernels against
            their plain versions for S/H/D: G in {1, 3, 64}, C in
            {1, 8, 30}, K tails (70) and N overhangs (1408), ragged with
            empty groups and row tiles of 8 (under the 16-row grain), 16
            and 128, every table instance once, and moonshot's decode
            shapes;
7. moe serve — olmo's weights freed, moonshot-v1-16b-a3b at full width
            and full depth (48 layers, 64 experts top-6, bf16, 56 GB of
            random weights) serves 5 requests (after an uncounted warm-up)
            under ``auto`` and under the forced kernel; both the grouped
            and the IAAT kernel's launch counts must be > 0 under both;
8. moe step — one full-width decode step, kernel against the plain
            arithmetic, logits compared, and the share of (token, layer)
            expert choices the two runs agree on;
9. kernels — times at the main-path shapes (olmo's 2-D GEMMs, moonshot's
            grouped ones), printed as the ``kernels`` JSON line;
10. flash check — the CUDA flash attention kernel against its plain
            version, f32 and bf16: B in {1, 3}, (Hq, Hkv) in {(16, 16),
            (8, 2), (4, 1)}, D in {64, 128, 256}, Sq = Sk in {1, 23, 80,
            300}, causal on and off, window in {None, 24, 512}; every head
            dim instance; a decode-like query (Sq 1, Sk 64, q_offset 63),
            one with no valid key, and strided head views;
11. wave serve — olmo-1b (the paged phases' weights) serves the paged
            phase's 6 requests through the wave ContinuousBatcher under
            ``auto`` and under the forced kernel: flash launches 16 per
            prefill wave and none in decode, IAAT launches > 0; then one
            2048-token prompt under ``auto``;
12. wave step — one full-width wave prefill through the kernels against
            the plain arithmetic, logits compared; and the share of tokens
            ContinuousBatcher(slots=1) and PagedEngine agree on (bf16: a
            share, not a gate);
13. flash kernels — flash kernel / plain / SDPA times and the bound at
            the wave's prefill shape and at B 1 x 16 heads x S 2048 x D 128;
14. grid check — the paper's grid (configs/paper_gemm.py: S/D/C/Z x
            NN/NT/TN/TT, M = N = K = 2..80, to 32 for TN), ragged
            non-cubes, .T and sliced views, alpha (complex for C/Z) with
            and without C, through api.gemm under the forced kernel, each
            output finite and within the reference's _RTOL of the plain
            version; counted from 0, the real and the complex kernel must
            both launch (run right after phase 3);
15. pack baseline — core/dispatch.traditional_gemm (pad + transpose
            copies, one fixed kernel) against the IAAT plan at the
            paper's sizes per letter: times, ratio, packed bytes (run
            after phase 14);
16. tune  — repro_torch.tune's sweep on the card over S/D/C/Z x four
            transpositions, cube classes 8..2048, and moonshot's grouped
            decode classes; the profile written to a temporary cache,
            loaded, and the grid run again under named_policy("tuned"):
            every measured class routes by the profile to its winner;
            the measured crossover per letter and transposition;
17. complex kernels — the complex kernel / plain / torch.matmul times
            and the bound for C and Z at 80^3, 512^3 and 2048^3.

The last line is {"ok": true, "device": {...}}; it is printed only when
every phase passed.  Without CUDA, or without the repository around it,
the script exits non-zero and prints no result.
"""
import itertools
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
#: flash kernel vs plain: the reference's f32 tolerance for its shape
#: sweep (``tests/test_kernels_other.py:41``), as allclose
FLASH_TOL_F32 = 3e-5
#: bf16: both sides take f32 sums of the same exact products and round
#: once, so they differ by at most one bf16 step of the larger value
BF16_STEP = 2.0 ** -7
#: full-width decode step, kernel vs plain arithmetic: every projection
#: rounds to bf16 and a one-step rounding flip in one of 16 (48) layers
#: propagates; held to 5% of the largest logit
STEP_TOL = 5e-2
MOE_ARCH = "moonshot-v1-16b-a3b"


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
    from repro_torch.kernels import build, flash_attention
    import re
    t0 = time.perf_counter()
    n = kernelgen.install()
    lib = build.build()         # already built: returns its path
    ptx = (lib.parent / "ptxas.log").read_text()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "ptxas.log").write_text(ptx)   # registers, spills per kernel
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", ptx)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", ptx))
    per = {name: len(re.findall(rf"Compiling entry function '\w*{name}",
                                ptx))
           for name in ("iaat_gemm_kernel", "batched_gemm_kernel",
                        "ragged_gemm_kernel", "cx_gemm_kernel",
                        "flash_attention_kernel")}
    real = sum(1 for i in kernelgen.instances()
               if i[0] in kernelgen.KERNEL_LETTERS)
    cx = n - real
    log(f"build: {real} real instances x {len(build.SOURCES)} sources + "
        f"{cx} complex x {len(build.SOURCES_CX)} + "
        f"{len(build.SOURCES_ONCE)} once in "
        f"{time.perf_counter() - t0:.1f}s, {len(regs)} kernels "
        f"{json.dumps(per)}, max {max(regs)} registers, {spills} bytes "
        f"spill stores -> {lib}")
    # the flash instances: (dtype, head dim) from the mangled name
    flash = []
    for entry in ptx.split("Compiling entry function")[1:]:
        m = re.search(r"flash_attention_kernelI(\w+?)Li(\d+)E", entry)
        if m:
            flash.append({
                "dtype": "bf16" if "bfloat16" in m.group(1) else "f32",
                "D": int(m.group(2)),
                "registers": int(re.search(r"Used (\d+) registers",
                                           entry).group(1)),
                "spill_stores": int(re.search(
                    r"(\d+) bytes spill stores", entry).group(1))})
    flash.sort(key=lambda f: (f["dtype"], f["D"]))
    log("build: flash_attention instances (registers, spill bytes): "
        + ", ".join(f"{f['dtype']} D{f['D']} {f['registers']}/"
                    f"{f['spill_stores']}" for f in flash))
    want_flash = 2 * len(flash_attention.HEAD_DIMS)
    want = {"iaat_gemm_kernel": real, "batched_gemm_kernel": real,
            "ragged_gemm_kernel": real, "cx_gemm_kernel": cx,
            "flash_attention_kernel": want_flash}
    if len(regs) != 3 * real + cx + want_flash or \
            len(flash) != want_flash or per != want:
        raise RuntimeError("ptxas reported another kernel count than the "
                           f"table's {want}: {per}")
    # the complex instances: registers and spills, from the ptxas report
    cxr = [(int(re.search(r"Used (\d+) registers", e).group(1)),
            int(re.search(r"(\d+) bytes spill stores", e).group(1)))
           for e in ptx.split("Compiling entry function")[1:]
           if "cx_gemm_kernel" in e.split("'")[1]]
    log(f"build: cx_gemm instances use {min(r for r, _ in cxr)}.."
        f"{max(r for r, _ in cxr)} registers, "
        f"{sum(sp for _, sp in cxr)} bytes of spill stores in all")
    return flash


def _rel_err(got, want):
    """max|got - want| and that over max|want|, in f64 (complex128 for a
    complex operand, so that the imaginary parts count)."""
    import torch
    wide = torch.complex128 if got.is_complex() or want.is_complex() else \
        torch.float64
    d = (got.to(wide) - want.to(wide)).abs().max().item()
    return d, d / max(want.to(wide).abs().max().item(), 1e-30)


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


def _reset_counts():
    """Every kernel's launch count and the Router's shape log to 0."""
    from repro_torch import obs
    from repro_torch.kernels import flash_attention, grouped_gemm, iaat_gemm
    obs.ROUTES.reset()
    iaat_gemm.reset_launch_count()
    grouped_gemm.reset_launch_count()
    flash_attention.reset_launch_count()


def _counts():
    from repro_torch.kernels import flash_attention, grouped_gemm, iaat_gemm
    return {"iaat_gemm": iaat_gemm.launch_count("iaat_gemm"),
            "cx_gemm": iaat_gemm.launch_count("cx_gemm"),
            "batched_gemm": grouped_gemm.launch_count("batched_gemm"),
            "ragged_gemm": grouped_gemm.launch_count("ragged_gemm"),
            "flash_attention": flash_attention.launch_count()}


def phase_serve(torch, arch, cfg, requests, max_new, kernels):
    """``arch`` at full width serves ``requests`` prompts under ``auto``
    and under the forced kernel, after an uncounted warm-up; every kernel
    in ``kernels`` must have launched in both runs.  Returns the runs'
    numbers and the weights."""
    from repro_torch import obs
    from repro_torch.launch import serve as serve_mod
    runs = {}
    # warm-up, not counted: weights, cuBLAS and allocator set-up, first
    # launches
    params = serve_mod.serve(arch, requests=1, max_new=2, backend="auto",
                             seed=0, device="cuda")["params"]
    for backend in ("auto", "kernel"):
        _reset_counts()
        r = serve_mod.serve(arch, requests=requests, slots=4,
                            max_new=max_new, block_size=16, backend=backend,
                            seed=0, device="cuda", params=params)
        launches = _counts()
        to_kernel, routed = obs.ROUTES.kernel_share()
        params = r["params"]
        done = r["done"]
        if sorted(done) != list(range(requests)):
            raise AssertionError(f"served {sorted(done)}, want {requests} "
                                 "requests")
        for rid, toks in done.items():
            if not 1 <= len(toks) <= max_new or not all(
                    0 <= t < cfg.vocab_padded for t in toks):
                raise AssertionError(f"request {rid}: bad tokens {toks}")
        for k in kernels:
            if launches[k] <= 0:
                raise AssertionError(f"{arch} {backend}: {k} never ran")
        per_tok = {k: launches[k] / r["tokens"] for k in kernels}
        runs[backend] = {"tokens": r["tokens"], "seconds": r["seconds"],
                         "tok_s": r["tok_s"],
                         "launches": launches[kernels[0]],
                         "launch_counts": launches,
                         "launches_per_token": per_tok,
                         "decode_steps": r["decode_steps"],
                         "routed": routed, "to_kernel": to_kernel}
        log(f"serve {arch} [{backend}]: {r['tokens']} tokens in "
            f"{r['seconds']:.3f}s = {r['tok_s']:.2f} tok/s, "
            f"{r['decode_steps']} decode steps, launches "
            f"{json.dumps(launches)}, per token "
            f"{json.dumps({k: round(v, 2) for k, v in per_tok.items()})}, "
            f"routed GEMMs to the kernel {to_kernel}/{routed} = "
            f"{to_kernel / routed:.4f}")
        runs[backend]["done"] = done
    same = sum(runs["auto"]["done"][i] == runs["kernel"]["done"][i]
               for i in range(requests))
    log(f"serve {arch}: {same}/{requests} requests token-identical between "
        "auto and kernel")
    for v in runs.values():
        v.pop("done")
    return runs, params


class _ExpertChoices:
    """Wraps ``layers._top_k`` (the MoE router's top-k) for one decode
    step: records each layer's chosen experts, or, given the choices of
    an earlier run, returns those instead (the pinned run)."""

    def __init__(self, layers, pinned=None):
        self.layers, self.pinned, self.seen = layers, pinned, []

    def __enter__(self):
        self.orig = self.layers._top_k

        def top_k(probs, k):
            if self.pinned is not None:
                idx = self.pinned[len(self.seen)]
                vals = probs.gather(-1, idx)
            else:
                vals, idx = self.orig(probs, k)
            self.seen.append(idx)
            return vals, idx
        self.layers._top_k = top_k
        return self

    def __exit__(self, *exc):
        self.layers._top_k = self.orig


def phase_step(torch, cfg, params):
    """One decode step over 4 slots after a prefill of each, through the
    kernel and through the plain arithmetic, on identical pool copies.
    For an MoE model, also the share of (token, layer) top-k expert sets
    the two runs agree on; if a flipped choice puts the logits past the
    tolerance, the plain run is repeated pinned to the kernel run's
    choices, and the result says so."""
    import copy
    from repro_torch import api
    from repro_torch.models import layers, lm
    kern, plain = api.Policy(backend="kernel"), api.Policy(backend="library")
    BS, slots, nmax = 16, 4, 4
    ps = lm.init_paged_state(cfg, 1 + slots * nmax, BS, slots,
                             cfg.compute_dtype, "cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    tables = torch.arange(1, 1 + slots * nmax, device="cuda").reshape(
        slots, nmax)
    lens = [5, 12, 20, 9]
    moe = cfg.family == "moe"
    out = {"name": cfg.name}
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
        ps2, ps3 = copy.deepcopy(ps), copy.deepcopy(ps)
        with _ExpertChoices(layers) as ck:
            lk = lm.paged_decode(params, cfg, kern, cur, ps, tables, pos)
        with _ExpertChoices(layers) as cp:
            lp = lm.paged_decode(params, cfg, plain, cur, ps2, tables, pos)
        torch.cuda.synchronize()
        ab, rel = _rel_err(lk, lp)
        if moe:
            same = torch.stack([
                (a.sort(-1).values == b.sort(-1).values).all(-1)
                for a, b in zip(ck.seen, cp.seen)])      # (layers, tokens)
            out["expert_sets_agree"] = same.float().mean().item()
            out["expert_sets_flipped"] = int((~same).sum().item())
            out["expert_sets"] = same.numel()
            out["flipped_per_layer"] = (~same).sum(-1).tolist()
            first = next((i for i, n in enumerate(out["flipped_per_layer"])
                          if n), None)
            log(f"step {cfg.name}: (token, layer) top-{cfg.moe.top_k} expert "
                f"sets agreeing kernel vs plain: "
                f"{out['expert_sets_agree']:.4f} "
                f"({out['expert_sets_flipped']} of {same.numel()} flipped, "
                f"the first in layer {first})")
            out["pinned"] = False
            if not rel <= STEP_TOL and out["expert_sets_flipped"]:
                log(f"step {cfg.name}: rel err {rel:.3g} > {STEP_TOL} with "
                    "flipped expert choices: plain run repeated pinned to "
                    "the kernel run's choices")
                out["unpinned_rel_err"] = rel
                with _ExpertChoices(layers, pinned=ck.seen):
                    lp = lm.paged_decode(params, cfg, plain, cur, ps3,
                                         tables, pos)
                torch.cuda.synchronize()
                ab, rel = _rel_err(lk, lp)
                out["pinned"] = True
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError("non-finite logits")
    if tuple(lk.shape) != (slots, 1, cfg.vocab_padded):
        raise AssertionError(f"logits shape {tuple(lk.shape)}")
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    log(f"step {cfg.name}: full-width paged_decode kernel vs plain: max abs "
        f"err {ab:.4g}, rel {rel:.3g} (tol {STEP_TOL}), argmax agreement "
        f"{agree:.2f}")
    if not rel <= STEP_TOL:
        raise AssertionError(f"decode step rel err {rel} > {STEP_TOL}")
    out.update({"max_abs_err": ab, "rel_err": rel, "argmax_agree": agree})
    return out


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


def _grouped_decode_shapes(mcfg):
    """(K, N) of the MoE model's expert GEMMs with their count per layer:
    gate and up (d, f), down (f, d)."""
    d, f = mcfg.d_model, mcfg.moe.d_expert
    return {(d, f): 2, (f, d): 1}


def _decode_counts(torch, mcfg, tokens=4, seed=5):
    """Rows per expert of one decode step over ``tokens`` slots, each
    choosing top-k distinct experts (drawn from ``seed``)."""
    E, k = mcfg.moe.num_experts, mcfg.moe.top_k
    g = torch.Generator().manual_seed(seed)
    counts = [0] * E
    for _ in range(tokens):
        for e in torch.randperm(E, generator=g)[:k].tolist():
            counts[e] += 1
    return counts


def _ragged_operands(torch, g, counts, bm, K, N, dt, empty_tile, G=None):
    """x (T, K) group-contiguous for ``counts`` rows per group, each
    group's rows padded with zeros to whole tiles of ``bm``; an empty
    group gets one zero tile when ``empty_tile`` (the reference's
    layout), none otherwise, and groups past ``len(counts)`` get none.
    w (G, K, N); tile group ids on the card."""
    xs, gids = [], []
    for e, c in enumerate(counts):
        tiles = -(-c // bm) if c else int(empty_tile)
        if not tiles:
            continue
        blk = torch.randn((tiles * bm, K), generator=g, device="cuda")
        blk[c:] = 0
        xs.append(blk)
        gids += [e] * tiles
    w = torch.randn((G or len(counts), K, N), generator=g, device="cuda")
    return (torch.cat(xs).to(dt), (w / math.sqrt(K)).to(dt),
            torch.tensor(gids, dtype=torch.int32, device="cuda"))


def phase_grouped_check(torch, mcfg):
    """The batched and ragged kernels against their plain versions.
    Returns the max abs errors at the MoE decode shapes and the ragged
    kernel's launches here (no model calls it)."""
    from repro_torch.core import kernelgen
    from repro_torch.kernels import grouped_gemm as gg
    _reset_counts()
    g = torch.Generator(device="cuda").manual_seed(4)
    dts = {"S": torch.float32, "D": torch.float64, "H": torch.bfloat16}
    worst = {}

    def check(name, letter, got, want, what):
        torch.cuda.synchronize()
        ab, rel = _rel_err(got, want)
        key = f"{name} {letter}"
        worst[key] = max(worst.get(key, 0.0), rel)
        if not rel <= TOL[letter]:
            raise AssertionError(f"{name} {letter} {what}: rel err {rel} > "
                                 f"{TOL[letter]}")
        return ab

    def batched_operands(G, C, K, N, dt):
        x = torch.randn((G, C, K), generator=g, device="cuda").to(dt)
        w = torch.randn((G, K, N), generator=g, device="cuda")
        return x, (w / math.sqrt(K)).to(dt)

    for letter, dt in dts.items():
        for G, C, K in itertools.product((1, 3, 64), (1, 8, 30),
                                         (70, 1408)):
            x, w = batched_operands(G, C, K, 1408, dt)
            check("batched", letter, gg.batched_gemm(x, w),
                  gg.batched_gemm_plain(x, w), f"G={G} C={C} K={K} N=1408")
        for bm, K in itertools.product((8, 16, 128), (70, 1408)):
            # groups 0 and 3 empty (one zero tile), 6 and 7 with no tile
            x, w, ids = _ragged_operands(torch, g, [0, 5, 17, 0, 40, 3], bm,
                                         K, 1408, dt, empty_tile=True, G=8)
            check("ragged", letter, gg.ragged_gemm(x, w, ids, bm=bm),
                  gg.ragged_gemm_plain(x, w, ids, bm),
                  f"tile {bm} K={K} N=1408")
        for (lt, bm, bn, bk) in kernelgen.instances():
            if lt != letter:
                continue
            x, w = batched_operands(3, 30, 70, 300, dt)
            check("batched", letter,
                  gg.batched_gemm(x, w, blocks=(bm, bn, bk)),
                  gg.batched_gemm_plain(x, w), f"instance {bm}x{bn}x{bk}")
            x, w, ids = _ragged_operands(torch, g, [0, 5, 17], 8, 70, 300,
                                         dt, empty_tile=True)
            check("ragged", letter,
                  gg.ragged_gemm(x, w, ids, bm=8, blocks=(bm, bn, bk)),
                  gg.ragged_gemm_plain(x, w, ids, 8),
                  f"instance {bm}x{bn}x{bk}")
    main = {"batched_gemm": 0.0, "ragged_gemm": 0.0}
    E = mcfg.moe.num_experts
    C = _decode_capacity(mcfg)
    counts = _decode_counts(torch, mcfg)
    for (K, N) in _grouped_decode_shapes(mcfg):
        x, w = batched_operands(E, C, K, N, torch.bfloat16)
        ab = check("batched", "H", gg.batched_gemm(x, w),
                   gg.batched_gemm_plain(x, w), f"decode {E}x{C}x{K}x{N}")
        main["batched_gemm"] = max(main["batched_gemm"], ab)
        x, w, ids = _ragged_operands(torch, g, counts, 8, K, N,
                                     torch.bfloat16, empty_tile=False)
        ab = check("ragged", "H", gg.ragged_gemm(x, w, ids, bm=8),
                   gg.ragged_gemm_plain(x, w, ids, 8),
                   f"decode T={x.shape[0]} K={K} N={N}")
        main["ragged_gemm"] = max(main["ragged_gemm"], ab)
        log(f"check grouped decode K={K} N={N}: batched ({E}, {C}) max abs "
            f"err {main['batched_gemm']:.4g}, ragged {x.shape[0]} rows in "
            f"{ids.numel()} tiles of 8 max abs err {main['ragged_gemm']:.4g}")
    launches = _counts()
    log("check grouped: worst rel err (tol S 1e-5, H 8e-3, D 1e-12): "
        + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()})
        + f"; launches {json.dumps(launches)}")
    return main, launches["ragged_gemm"]


def _decode_capacity(mcfg, slots=4):
    from repro_torch.models import layers
    return layers._capacity(slots, mcfg.moe)


def _grouped_mm_library(torch, x, w, ids, bm):
    """The one PyTorch call that computes the ragged product:
    ``torch._grouped_mm`` of x (T, K) with w (G, K, N) at row offsets.  The
    tile ids are ascending and group-contiguous, so group g's rows end at
    bm times the number of tiles with an id <= g.  Returns (call, its
    output), or (None, the library's error) if it refuses the layout."""
    offs = (torch.bincount(ids.long(), minlength=w.shape[0]).cumsum(0)
            * bm).to(torch.int32)
    try:
        out = torch._grouped_mm(x, w, offs=offs)
    except RuntimeError as e:
        return None, str(e)
    return (lambda: torch._grouped_mm(x, w, offs=offs)), out


def phase_grouped_kernels(torch, mcfg, launches, errs):
    """Kernel / plain / library times and the bound of the grouped kernels
    at the MoE decode shapes (one batched call reads all experts' weights,
    >= 369 MB, over 7 x the 50 MB L2, so every call reads from HBM).  The
    line's numbers are one decode step's expert GEMMs (layers x gate, up,
    down), summed: as equal-capacity groups for batched_gemm, as the
    dropless ragged layout of the same 4 tokens for ragged_gemm.  The
    library calls are torch.bmm and torch._grouped_mm; the latter's
    output is first held against the plain version."""
    from repro_torch.core import cost
    from repro_torch.kernels import grouped_gemm as gg
    g = torch.Generator(device="cuda").manual_seed(6)
    bf = torch.bfloat16
    E, C, L = mcfg.moe.num_experts, _decode_capacity(mcfg), mcfg.n_layers
    counts = _decode_counts(torch, mcfg)
    rows = []
    step = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0,
                "bytes": 0} for n in ("batched_gemm", "ragged_gemm")}
    library = {}
    for (K, N), per_layer in _grouped_decode_shapes(mcfg).items():
        x = torch.randn((E, C, K), generator=g, device="cuda").to(bf)
        w = (torch.randn((E, K, N), generator=g, device="cuda") /
             math.sqrt(K)).to(bf)
        blocks = gg.pick_blocks(C, K, N, bf)
        xr, wr, ids = _ragged_operands(torch, g, counts, 8, K, N, bf,
                                       empty_tile=False)
        T, groups = xr.shape[0], len(set(ids.tolist()))
        rblocks = gg.pick_blocks(8, K, N, bf)
        lib_call, lib_out = _grouped_mm_library(torch, xr, wr, ids, 8)
        if lib_call is None:
            log(f"library torch._grouped_mm refused the ragged layout "
                f"K={K} N={N}: {lib_out}")
            library[(K, N)] = lib_out
        else:
            _, rel = _rel_err(lib_out, gg.ragged_gemm_plain(xr, wr, ids, 8))
            log(f"library torch._grouped_mm K={K} N={N} vs plain: rel err "
                f"{rel:.3g} (tol {TOL['H']})")
            if not rel <= TOL["H"]:
                raise AssertionError(f"torch._grouped_mm K={K} N={N}: rel "
                                     f"err {rel}")
            library[(K, N)] = "ok"
        # the ragged launch alone: the wrapper's id check reads the ids
        # back to the host once a call, which would idle the card here
        times = {
            "batched_gemm": (
                _time_ms(torch, lambda i: gg.batched_gemm(x, w, blocks=blocks),
                         20),
                _time_ms(torch, lambda i: gg.batched_gemm_plain(x, w), 20),
                _time_ms(torch, lambda i: torch.bmm(x, w), 20)),
            "ragged_gemm": (
                _time_ms(torch, lambda i: gg._launch_ragged(
                    xr, wr, ids, 8, rblocks), 20),
                _time_ms(torch, lambda i: gg.ragged_gemm_plain(xr, wr, ids,
                                                               8), 20),
                None if lib_call is None else
                _time_ms(torch, lambda i: lib_call(), 20)),
        }
        work = {   # bytes: each input read once (ragged: the groups used)
            "batched_gemm": (2 * E * C * K * N,
                             2 * (E * C * K + E * K * N + E * C * N)),
            "ragged_gemm": (2 * T * K * N,
                            2 * (T * K + groups * K * N + T * N)),
        }
        for name, (t_k, t_p, t_l) in times.items():
            flops, nbytes = work[name]
            b_s = max(flops / cost.PEAK_FLOPS_BF16, nbytes / cost.HBM_BW)
            row = {"kernel": name, "K": K, "N": N, "ms": t_k,
                   "plain_ms": t_p, "library_ms": t_l,
                   "bound_ms": b_s * 1e3, "flops": flops, "bytes": nbytes}
            if name == "ragged_gemm":
                row.update(rows=T, groups=groups)
            rows.append(row)
            log(f"kernel time {name} H K={K} N={N}"
                + (f" ({T} rows, {groups} groups)" if name == "ragged_gemm"
                   else f" ({E} x {C} rows)")
                + f": kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
                + ("library torch._grouped_mm" if name == "ragged_gemm"
                   else "library torch.bmm")
                + (" refused" if t_l is None else f" {t_l:.4f} ms")
                + f", bound {b_s * 1e3:.4f} ms")
            n = per_layer * L
            st = step[name]
            st["ms"] += n * t_k
            st["plain_ms"] += n * t_p
            st["library_ms"] = None if t_l is None or st["library_ms"] is \
                None else st["library_ms"] + n * t_l
            st["flops"] += n * flops
            st["bytes"] += n * nbytes
    entries = []
    for name, line in (("batched_gemm", 64), ("ragged_gemm", 112)):
        st = step[name]
        t_ops, t_bytes = st["flops"] / cost.PEAK_FLOPS_BF16, \
            st["bytes"] / cost.HBM_BW
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
            "replaces": f"src/repro/kernels/grouped_gemm.py:{line}",
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": st["ms"],
            "plain_ms": st["plain_ms"],
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": st["library_ms"],
            "at": f"one {mcfg.name} decode step's expert GEMMs ({L} layers "
                  "x gate, up, down), bf16, summed"
                  + (f"; {E} groups of C={C}" if name == "batched_gemm" else
                     "; dropless ragged layout of 4 tokens x top-"
                     f"{mcfg.moe.top_k}, row tiles of 8"),
        })
    entries[1]["library"] = "torch._grouped_mm; " + " / ".join(
        f"K={K} N={N}: {v}" for (K, N), v in library.items())
    return entries, rows


def _flash_err(torch, got, want, what):
    """Kernel vs plain, every output finite: allclose at FLASH_TOL_F32 in
    f32, within one bf16 step of the larger of the two values in bf16.
    Returns the max abs error."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash {what}: non-finite output")
    g, w = got.double(), want.double()
    d = (g - w).abs()
    if got.dtype == torch.float32:
        lim = FLASH_TOL_F32 + FLASH_TOL_F32 * w.abs()
    else:
        lim = BF16_STEP * torch.maximum(g.abs(), w.abs()) + 1e-6
    if not bool((d <= lim).all()):
        raise AssertionError(f"flash {what}: max abs err {d.max().item()}, "
                             f"past the tolerance at {int((d > lim).sum())} "
                             "outputs")
    return d.max().item()


def phase_flash_check(torch):
    """The flash kernel against its plain version on the card."""
    from repro_torch.kernels import flash_attention as fa
    _reset_counts()
    g = torch.Generator(device="cuda").manual_seed(7)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    worst = {}

    def run(name, B, Hq, Hkv, Sq, Sk, D, view=False, **kw):
        def mk(H, S):
            t = torch.randn((B, H, S, D), generator=g, device="cuda")
            t = t.to(dts[name])
            # a strided (B, H, S, D) view of a (B, S, H, D) tensor
            return t.transpose(1, 2).contiguous().transpose(1, 2) if view \
                else t
        q, k, v = mk(Hq, Sq), mk(Hkv, Sk), mk(Hkv, Sk)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        ab = _flash_err(torch, got, want, f"{name} B{B} H{Hq}/{Hkv} "
                        f"S{Sq}x{Sk} D{D} {kw}")
        key = f"{name} D{D}"
        worst[key] = max(worst.get(key, 0.0), ab)
        return got

    cases = 0
    for name, B, (Hq, Hkv), D, S, causal, window in itertools.product(
            dts, (1, 3), ((16, 16), (8, 2), (4, 1)), (64, 128, 256),
            (1, 23, 80, 300), (True, False), (None, 24, 512)):
        run(name, B, Hq, Hkv, S, S, D, causal=causal, window=window)
        cases += 1
    for name in dts:
        for D, window in itertools.product((16, 32), (None, 24)):
            run(name, 3, 8, 2, 80, 80, D, causal=True, window=window)
        for Hq, Hkv in ((16, 16), (8, 2)):     # a decode-like query
            run(name, 3, Hq, Hkv, 1, 64, 128, causal=True, q_offset=63)
        run(name, 2, 16, 16, 80, 80, 128, view=True, window=24)
        out = run(name, 1, 4, 1, 1, 64, 128, q_offset=200, window=24)
        if out.any():
            raise AssertionError("flash: a query with no valid key gave a "
                                 "non-zero row")
        cases += 8
    launches = _counts()["flash_attention"]
    log(f"check flash: {cases} cases, {launches} launches; worst max abs "
        f"err (f32 allclose {FLASH_TOL_F32}, bf16 one step): "
        + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()}))
    return {"cases": cases, "launches": launches, "worst_max_abs": worst}


def _wave_model(cfg, phases):
    """olmo's registry model with prefill and decode wrapped to record,
    per call, the token shape and the flash launches it made."""
    import dataclasses
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import registry
    base = registry.build(cfg)

    def prefill(params, tokens, be, cache_len=None):
        n0 = fa.launch_count()
        out = base.prefill(params, tokens, be, cache_len=cache_len)
        phases.append(("prefill", tuple(tokens.shape),
                       fa.launch_count() - n0))
        return out

    def decode(params, tokens, cache, be):
        n0 = fa.launch_count()
        out = base.decode(params, tokens, cache, be)
        phases.append(("decode", tuple(tokens.shape),
                       fa.launch_count() - n0))
        return out
    return dataclasses.replace(base, prefill=prefill, decode=decode)


def phase_wave_serve(torch, cfg, params, requests=6, max_new=16):
    """olmo-1b through the wave ContinuousBatcher (4 slots) on the paged
    phase's requests, under ``auto`` and the forced kernel, after an
    uncounted warm-up; then one 2048-token prompt under ``auto``.  Every
    prefill wave must launch the flash kernel once per layer and no
    decode step may launch it."""
    import numpy as np
    from repro_torch import api, obs
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve import ContinuousBatcher, Request
    phases = []
    model = _wave_model(cfg, phases)

    def run(backend, reqs, max_len=256):
        eng = ContinuousBatcher(model, params, api.named_policy(backend),
                                slots=4, max_len=max_len, seed=0)
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        torch.cuda.synchronize()
        return done, time.perf_counter() - t0

    def counted(backend, reqs, max_len=256):
        phases.clear()
        _reset_counts()
        done, dt = run(backend, reqs, max_len)
        launches = _counts()
        to_kernel, routed = obs.ROUTES.kernel_share()
        if sorted(done) != [r.rid for r in reqs]:
            raise AssertionError(f"wave served {sorted(done)}")
        for r in reqs:
            toks = done[r.rid]
            if not 1 <= len(toks) <= r.max_new or not all(
                    0 <= t < cfg.vocab_padded for t in toks):
                raise AssertionError(f"wave request {r.rid}: bad tokens "
                                     f"{toks}")
        pre = [(shape, n) for kind, shape, n in phases if kind == "prefill"]
        dec = [n for kind, _shape, n in phases if kind == "decode"]
        if any(n != cfg.n_layers for _s, n in pre) or any(dec):
            raise AssertionError(f"wave {backend}: flash launches per "
                                 f"prefill {[n for _s, n in pre]}, per "
                                 f"decode step {sorted(set(dec))}")
        for k in ("flash_attention", "iaat_gemm"):
            if launches[k] <= 0:
                raise AssertionError(f"wave {backend}: {k} never ran")
        tokens = sum(len(v) for v in done.values())
        out = {"tokens": tokens, "seconds": dt, "tok_s": tokens / dt,
               "launch_counts": launches,
               "launches_per_token": {k: launches[k] / tokens for k in
                                      ("iaat_gemm", "flash_attention")},
               "prefill_shapes": [list(sh) for sh, _n in pre],
               "flash_per_prefill": [n for _s, n in pre],
               "decode_steps": len(dec), "flash_in_decode": sum(dec),
               "routed": routed, "to_kernel": to_kernel}
        log(f"wave serve {cfg.name} [{backend}]: {tokens} tokens in "
            f"{dt:.3f}s = {tokens / dt:.2f} tok/s, {len(pre)} prefill waves "
            f"{out['prefill_shapes']}, {len(dec)} decode steps; flash "
            f"launches {launches['flash_attention']} "
            f"({out['flash_per_prefill']} per prefill, {sum(dec)} in "
            f"decode), IAAT {launches['iaat_gemm']}; routed GEMMs to the "
            f"kernel {to_kernel}/{routed} = {to_kernel / routed:.4f}")
        return out, done

    run("auto", serve_mod.random_requests(cfg, 1, 2, seed=1))   # warm-up
    runs = {}
    for backend in ("auto", "kernel"):
        runs[backend], _done = counted(
            backend, serve_mod.random_requests(cfg, requests, max_new,
                                               seed=0))
    prompt = np.random.RandomState(2).randint(0, cfg.vocab, 2048)
    runs["long"], done = counted("auto", [Request(0, prompt, max_new=4)],
                                 max_len=2048 + 4)
    if len(done[0]) != 4:
        raise AssertionError(f"long prompt: {len(done[0])} tokens, want 4")
    return runs


def phase_wave_step(torch, cfg, params):
    """One full-width wave prefill (4 left-padded prompts) through the
    kernels and through the plain arithmetic (the library route: the
    chunked oracle and exact f32-accumulated GEMMs), last-token logits
    compared; then the token agreement of ContinuousBatcher(slots=1) and
    PagedEngine on two requests, a share reported, not gated: their
    bf16 rounding orders differ."""
    from repro_torch import api
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import lm, registry
    from repro_torch.serve import ContinuousBatcher, PagedEngine
    kern, plain = api.Policy(backend="kernel"), api.Policy(backend="library")
    g = torch.Generator(device="cuda").manual_seed(8)
    lens = [5, 12, 23, 9]
    S = max(lens)
    toks = torch.zeros((len(lens), S), dtype=torch.long, device="cuda")
    for i, n in enumerate(lens):
        toks[i, S - n:] = torch.randint(0, cfg.vocab, (n,), generator=g,
                                        device="cuda")
    with torch.no_grad():
        lk, ck = lm.prefill(params, cfg, kern, toks, cache_len=S + 16)
        lp, cp = lm.prefill(params, cfg, plain, toks, cache_len=S + 16)
    torch.cuda.synchronize()
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError("wave prefill: non-finite logits")
    if tuple(lk.shape) != (len(lens), cfg.vocab_padded):
        raise AssertionError(f"wave prefill logits {tuple(lk.shape)}")
    ab, rel = _rel_err(lk, lp)
    _, krel = _rel_err(ck.attn_k, cp.attn_k)
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    log(f"wave step {cfg.name}: full-width prefill of {tuple(toks.shape)} "
        f"kernel vs plain: max abs err {ab:.4g}, rel {rel:.3g} (tol "
        f"{STEP_TOL}), argmax agreement {agree:.2f}; K cache rel err "
        f"{krel:.3g}")
    if not rel <= STEP_TOL:
        raise AssertionError(f"wave prefill rel err {rel} > {STEP_TOL}")
    model = registry.build(cfg)
    auto = api.named_policy("auto")
    outs = []
    for eng in (ContinuousBatcher(model, params, auto, slots=1, eos=-1),
                PagedEngine(model, params, auto, slots=4, eos=-1)):
        for r in serve_mod.random_requests(cfg, 2, 16, seed=0):
            eng.submit(r)
        outs.append(eng.run())
    same = sum(a == b for rid in outs[0]
               for a, b in zip(outs[0][rid], outs[1][rid]))
    total = sum(len(v) for v in outs[0].values())
    log(f"wave step {cfg.name}: ContinuousBatcher(slots=1) vs PagedEngine, "
        f"2 requests x 16 tokens (bf16, auto): {same}/{total} tokens agree "
        "position by position")
    return {"max_abs_err": ab, "rel_err": rel, "argmax_agree": agree,
            "k_cache_rel_err": krel, "tokens_agree": same,
            "tokens": total}


def phase_flash_kernels(torch, cfg, serve_shape, launches):
    """Flash kernel / plain / library times and the bound at the wave's
    first prefill shape (B x S) and at B 1 x S 2048, olmo's 16 heads x
    128, bf16, causal.  The library call is
    ``scaled_dot_product_attention(..., is_causal=True)``, timed here
    only; its output is first compared with the plain version (logged).
    The bound counts the causal pairs these inputs need: 4 D flops a
    pair, each of q, k, v read once and o written once."""
    from repro_torch.core import cost
    from repro_torch.kernels import flash_attention as fa
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(9)
    H, D = cfg.n_heads, cfg.head_dim_
    rows = []
    for B, S in (serve_shape, (1, 2048)):
        q, k, v = (torch.randn((B, H, S, D), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        want = fa.flash_attention_plain(q, k, v)
        ab = _flash_err(torch, fa.flash_attention(q, k, v), want,
                        f"timing shape B{B} S{S}")
        _, lib_rel = _rel_err(F.scaled_dot_product_attention(
            q, k, v, is_causal=True), want)
        reps = 50 if S < 1024 else 20
        t_k = _time_ms(torch, lambda i: fa.flash_attention(q, k, v), reps)
        t_p = _time_ms(torch, lambda i: fa.flash_attention_plain(q, k, v),
                       reps)
        t_l = _time_ms(torch, lambda i: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), reps)
        flops = 4 * D * (S * (S + 1) // 2) * B * H
        nbytes = 2 * 4 * B * H * S * D
        t_ops, t_bytes = flops / cost.PEAK_FLOPS_BF16, nbytes / cost.HBM_BW
        row = {"B": B, "H": H, "S": S, "D": D, "ms": t_k, "plain_ms": t_p,
               "library_ms": t_l, "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "flops": flops, "bytes": nbytes, "max_abs_err": ab,
               "library_rel_err": lib_rel}
        rows.append(row)
        log(f"kernel time flash_attention bf16 B={B} H={H} S={S} D={D} "
            f"causal: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library "
            f"(SDPA) {t_l:.4f} ms (rel err vs plain {lib_rel:.3g}), bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {flops / 1e9:.3f} "
            f"GFLOP, {nbytes / 1e6:.2f} MB); kernel vs plain max abs err "
            f"{ab:.4g}")
    main, long = rows
    entry = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "launches": launches,
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "at": f"one {cfg.name} wave prefill's attention, B {main['B']} x "
              f"{H} heads x S {main['S']} x D {D}, bf16, causal",
        "at_2048": {k: long[k] for k in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by",
                                         "max_abs_err")},
    }
    return entry, rows


# --------------------------------------------------------------------------
# The paper's S/D/C/Z grid: the complex kernel, the pack baseline, the
# install-time tuner.
# --------------------------------------------------------------------------

#: kernel vs plain on the paper's grid: the reference's own ``_RTOL``
#: (``tests/test_kernels_gemm.py:15``), held as max|kernel - plain| /
#: max|plain|; both sides take the same products (C/Z: the same Karatsuba
#: planes) and sum them in other orders
GRID_TOL = {"S": 2e-5, "D": 1e-12, "C": 2e-4, "Z": 1e-12}
GRID_DT = {}          # letter -> torch dtype, filled in by main()
#: ragged non-cubes (M, N, K) every letter and transposition also runs
GRID_RAGGED = ((7, 130, 33), (65, 3, 129), (1, 1, 1), (33, 300, 130))


def _grid_operand(torch, g, shape, letter):
    x = torch.randn(shape, generator=g, device="cuda", dtype=torch.float64)
    if letter in ("C", "Z"):
        x = torch.complex(x, torch.randn(shape, generator=g, device="cuda",
                                         dtype=torch.float64))
    return x.to(GRID_DT[letter])


def _grid_cases(torch, g):
    """Every case of the grid phases: (letter, trans, M, N, K, a, b, c,
    alpha, beta, trans_a, trans_b, what).  The paper's grid
    (``configs/paper_gemm.py``: S/D/C/Z x NN/NT/TN/TT, M = N = K = 2..80
    in steps of 2, to 32 for TN) alternating without C (alpha only) and
    with C (alpha and beta, complex for C/Z); then ragged non-cubes; then
    operands that are ``.T`` views (the transposition carried by the view,
    not by the flag) and sliced, non-contiguous views."""
    from repro_torch.configs import paper_gemm
    cfg = paper_gemm.CONFIG
    for letter in cfg.letters:
        cx = letter in ("C", "Z")
        scal = ((0.75 + 1.25j, 0.0), (1.5 - 0.5j, 0.25 + 2j)) if cx else \
            ((0.75, 0.0), (1.5, -0.5))
        for trans in cfg.transpositions:
            dims = [(n, n, n) for n in cfg.sizes(trans)] + list(GRID_RAGGED)
            for i, (M, N, K) in enumerate(dims):
                alpha, beta = scal[i % 2]
                a = _grid_operand(torch, g, (M, K) if trans[0] == "N"
                                  else (K, M), letter)
                b = _grid_operand(torch, g, (K, N) if trans[1] == "N"
                                  else (N, K), letter)
                c = _grid_operand(torch, g, (M, N), letter) if beta else None
                yield (letter, trans, M, N, K, a, b, c, alpha, beta,
                       trans[0] == "T", trans[1] == "T", f"{M}x{N}x{K}")
        # a .T view with the NN flags (op(A) is stored (K, M)) and sliced
        # views with rows and columns of stride 2
        M, N, K = 45, 70, 37
        at = _grid_operand(torch, g, (K, M), letter).T
        bt = _grid_operand(torch, g, (N, K), letter).T
        yield (letter, "NN", M, N, K, at, bt, None, scal[0][0], 0.0, False,
               False, ".T views")
        a = _grid_operand(torch, g, (2 * M, 2 * K), letter)[::2, 1::2]
        b = _grid_operand(torch, g, (2 * N, K + 3), letter)[::2, 3:]
        c = _grid_operand(torch, g, (M, 2 * N), letter)[:, ::2]
        yield (letter, "NT", M, N, K, a, b, c, *scal[1], False, True,
               "sliced views")


def _run_grid(torch, policy, check_route=None):
    """``api.gemm`` under ``policy`` over every grid case, each output
    finite and within GRID_TOL of the plain version.  ``check_route(d,
    letter, trans, M, N, K)`` sees each case's Decision first.  Returns
    (cases, worst rel err per letter and trans, max abs err per letter)."""
    from repro_torch import api
    from repro_torch.core import kernelgen
    from repro_torch.kernels import iaat_gemm
    g = torch.Generator(device="cuda").manual_seed(15)
    worst, max_abs, cases = {}, {}, 0
    for (letter, trans, M, N, K, a, b, c, alpha, beta, ta, tb,
         what) in _grid_cases(torch, g):
        tr = ("T" if ta else "N") + ("T" if tb else "N")
        if check_route is not None:
            check_route(api.route("gemm", (M, N, K), letter, tr,
                                  policy=policy), letter, tr, M, N, K)
        out = api.gemm(a, b, c, alpha, beta, ta, tb, policy=policy)
        want = iaat_gemm.gemm_region_plain(
            kernelgen.kernel_table(letter, tr)[0], a, b, c, alpha, beta)
        torch.cuda.synchronize()
        if tuple(out.shape) != (M, N) or out.dtype != GRID_DT[letter] or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"grid {letter} {tr} {what}: shape "
                                 f"{tuple(out.shape)}, {out.dtype}, or a "
                                 "non-finite output")
        ab, rel = _rel_err(out, want)
        key = f"{letter}{trans}"
        worst[key] = max(worst.get(key, 0.0), rel)
        max_abs[letter] = max(max_abs.get(letter, 0.0), ab)
        if not rel <= GRID_TOL[letter]:
            raise AssertionError(f"grid {letter} {tr} {what} c={c is not None}"
                                 f": rel err {rel} > {GRID_TOL[letter]}")
        cases += 1
    return cases, worst, max_abs


def phase_grid_check(torch):
    """This slice's main path: ``api.gemm`` under the forced kernel policy
    over the paper's whole S/D/C/Z grid, every kernel launch counted from
    0; both the real and the complex kernel must have launched."""
    from repro_torch import api
    _reset_counts()
    cases, worst, max_abs = _run_grid(torch, api.Policy(backend="kernel"))
    launches = _counts()
    log(f"grid check (forced kernel): {cases} GEMMs, launches "
        f"{json.dumps({k: launches[k] for k in ('iaat_gemm', 'cx_gemm')})}"
        "; worst rel err (tol S 2e-5, D 1e-12, C 2e-4, Z 1e-12): "
        + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()}))
    for k in ("iaat_gemm", "cx_gemm"):
        if launches[k] <= 0:
            raise AssertionError(f"grid check: {k} never ran")
    return {"cases": cases, "launches": launches, "worst_rel": worst,
            "max_abs_err": max_abs}


def phase_pack(torch):
    """The paper's Fig. 3 question on this card: the pack-step baseline
    (``core/dispatch.traditional_gemm``: transpose-normalise and pad both
    operands into fresh buffers, one fixed kernel) against the IAAT plan
    (``api.gemm`` under the forced kernel) at the paper's sizes, per
    letter; CUDA-event times of each, their ratio, and the bytes the pack
    step moves (``traditional_pack_bytes``).  Both outputs are first held
    against the plain version."""
    from repro_torch import api
    from repro_torch.core import dispatch, kernelgen
    from repro_torch.kernels import iaat_gemm
    kern = api.Policy(backend="kernel")
    g = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for letter in ("S", "D", "C", "Z"):
        for trans, sizes in (("NN", (8, 16, 32, 48, 64, 80)),
                             ("TN", (8, 16, 32))):
            ta = trans[0] == "T"
            for n in sizes:
                a = _grid_operand(torch, g, (n, n), letter)
                b = _grid_operand(torch, g, (n, n), letter)
                want = iaat_gemm.gemm_region_plain(
                    kernelgen.kernel_table(letter, trans)[0], a, b)
                for name, fn in (
                        ("pack", lambda: dispatch.traditional_gemm(
                            a, b, trans_a=ta)),
                        ("iaat", lambda: api.gemm(a, b, trans_a=ta,
                                                  policy=kern))):
                    _, rel = _rel_err(fn(), want)
                    if not rel <= GRID_TOL[letter]:
                        raise AssertionError(f"pack phase {name} {letter} "
                                             f"{trans} {n}: rel err {rel}")
                t_pack = _time_ms(torch, lambda i: dispatch.traditional_gemm(
                    a, b, trans_a=ta), 50)
                t_iaat = _time_ms(torch, lambda i: api.gemm(
                    a, b, trans_a=ta, policy=kern), 50)
                rows.append({"letter": letter, "trans": trans, "n": n,
                             "pack_ms": t_pack, "iaat_ms": t_iaat,
                             "ratio": t_pack / t_iaat,
                             "pack_bytes": dispatch.traditional_pack_bytes(
                                 n, n, n, GRID_DT[letter])})
    for letter in ("S", "D", "C", "Z"):
        log(f"pack baseline {letter} (fixed kernel "
            f"{dispatch.PACK_SIG[letter]}): " + ", ".join(
                f"{r['trans']} {r['n']}: pack {r['pack_ms']:.4f} ms / iaat "
                f"{r['iaat_ms']:.4f} ms = {r['ratio']:.2f}x "
                f"({r['pack_bytes']} B packed)"
                for r in rows if r["letter"] == letter))
    return rows


def _crossovers(prof, letters, transes):
    """Per letter and transposition: the cube classes measured in order,
    the winner of each, and the measured crossover, the largest cube
    representative at which the kernel beat the library (None: never)."""
    from repro_torch.tune import classes
    out = {}
    for letter in letters:
        for tr in transes:
            wins = []
            for key, e in prof.entries.items():
                if key.startswith(f"{letter}/{tr}/"):
                    n = classes.representative(
                        classes.SizeClass.from_key(key))[0]
                    wins.append((n, e.prefer_kernel, e.kernel.median_us,
                                 e.library.median_us,
                                 e.sig.name if e.sig else None))
            wins.sort()
            out[f"{letter}{tr}"] = {
                "classes": wins,
                "crossover": max((n for n, k, *_ in wins if k),
                                 default=None)}
    return out


def phase_tune(torch, mcfg):
    """The install-time stage on the card: ``tune.search.sweep`` over
    S/D/C/Z x NN/NT/TN/TT on the cube classes from 8 to 2048 (the top 3
    kernel candidates by CUDA events against the library, TF32 off), run
    twice (the first sweep only says how stable the winners are), plus
    the grouped classes of moonshot's decode step timed on
    ``batched_gemm``.
    No candidate may fail.  The profile is written to a temporary cache
    dir, loaded from there as the active profile, and the grid runs again
    under ``named_policy("tuned")``: every case whose class was measured
    must route with source "profile" to the recorded winner, and agree
    with the plain version.  Prints the measured crossover per letter and
    transposition."""
    import os
    import tempfile
    from repro_torch import api
    from repro_torch.tune import classes, profile as profile_mod, search
    from repro_torch.tune import timer
    letters, transes = ("S", "D", "C", "Z"), ("NN", "NT", "TN", "TT")
    n_failed = len(timer.FAILURES)
    # two sweeps: the second is the profile, the first says how far a
    # winner can be trusted (both sides are host-bound at small sizes)
    sweeps, t_sweep = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        sweeps.append(search.sweep(letters, transes, min_dim=8,
                                   max_dim=2048, cube_only=True, top=3,
                                   warmup=3, reps=10, device="cuda"))
        t_sweep.append(time.perf_counter() - t0)
    first, prof = sweeps
    agree = sum(e.prefer_kernel == first.entries[k].prefer_kernel
                for k, e in prof.entries.items())
    E, C = mcfg.moe.num_experts, _decode_capacity(mcfg)
    grouped = {}
    for (K, N) in _grouped_decode_shapes(mcfg):
        sc = classes.size_class(C, N, K, "H", "NN")
        e = search.tune_grouped_class(sc, G=E, top=2, warmup=2, reps=5,
                                      device="cuda")
        prof.record_grouped(sc, e)
        grouped[(K, N)] = (sc, e)
    failed = timer.FAILURES[n_failed:]
    if failed:
        raise AssertionError(f"tune: {len(failed)} candidates failed: "
                             f"{failed[:5]}")
    cross = _crossovers(prof, letters, transes)
    cross_first = _crossovers(first, letters, transes)
    for key, v in cross.items():
        log(f"tune {key}: kernel wins at "
            f"{[n for n, k, *_ in v['classes'] if k]}, library at "
            f"{[n for n, k, *_ in v['classes'] if not k]}; measured "
            f"crossover {v['crossover']} (first sweep: "
            f"{cross_first[key]['crossover']})")
    n_kernel = sum(e.prefer_kernel for e in prof.entries.values())
    log(f"tune: {len(prof)} classes ({len(prof) - len(grouped)} 2-D, "
        f"{len(grouped)} grouped), sweeps of {t_sweep[0]:.1f}s and "
        f"{t_sweep[1]:.1f}s whose winners agree on {agree} of "
        f"{len(first)} 2-D classes; {n_kernel} prefer the kernel; grouped "
        f"(G {E}, C {C}): " + ", ".join(
            f"K={K} N={N} rep {classes.representative(sc)}: kernel "
            f"{e.kernel.median_us:.1f} us ({e.sig.name}) vs einsum "
            f"{e.library.median_us:.1f} us"
            for (K, N), (sc, e) in grouped.items()))

    tuned = api.named_policy("tuned")
    seen = {"profile": 0, "analytical": 0}

    def check_route(d, letter, trans, M, N, K):
        entry = prof.lookup_dims(M, N, K, letter, trans)
        if entry is None:
            if d.source != "analytical":
                raise AssertionError(f"tuned {letter} {trans} {M}x{N}x{K}: "
                                     f"unmeasured class routed by {d.source}")
        elif (d.source, d.use_kernel, d.sig) != (
                "profile", entry.prefer_kernel,
                entry.sig if entry.prefer_kernel else None):
            raise AssertionError(f"tuned {letter} {trans} {M}x{N}x{K}: {d} "
                                 f"is not the profile's winner {entry}")
        seen[d.source] += 1

    env = os.environ.get(profile_mod.CACHE_ENV)
    with tempfile.TemporaryDirectory() as cache:
        os.environ[profile_mod.CACHE_ENV] = cache
        try:
            path = prof.save()
            profile_mod.clear_active_profile()
            active = profile_mod.active_profile()     # loaded from path
            if active is None or active.to_json() != prof.to_json():
                raise AssertionError(f"tune: the profile at {path} did not "
                                     "load as the active profile")
            _reset_counts()
            cases, worst, _ = _run_grid(torch, tuned, check_route)
            launches = _counts()
            for (K, N), (sc, e) in grouped.items():
                d = api.route("batched_gemm", (E, C, K, N), "H",
                              policy=tuned)
                if (d.source, d.use_kernel, d.blocks) != (
                        "profile", e.prefer_kernel,
                        (e.sig.bm, e.sig.bn, e.sig.bk)):
                    raise AssertionError(f"tuned grouped K={K} N={N}: {d}")
        finally:
            profile_mod.set_active_profile(None)
            if env is None:
                os.environ.pop(profile_mod.CACHE_ENV, None)
            else:
                os.environ[profile_mod.CACHE_ENV] = env
    log(f"tune: grid under named_policy('tuned'): {cases} GEMMs, "
        f"{seen['profile']} routed by the profile (each to its recorded "
        f"winner), {seen['analytical']} analytical (no class measured: sizes "
        f"2..7, the ragged non-cubes, the view cases); launches {json.dumps(launches)}; worst rel err "
        + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()}))
    return {"seconds_sweep": t_sweep, "classes": len(prof),
            "prefer_kernel": n_kernel, "crossover": cross,
            "crossover_first_sweep": cross_first,
            "winners_agree": [agree, len(first)],
            "grouped": {f"{K}x{N}": e.to_json()
                        for (K, N), (sc, e) in grouped.items()},
            "tuned_grid": {"cases": cases, "routes": seen,
                           "launches": launches}}


def phase_complex_kernels(torch, launches, max_abs_err):
    """Complex kernel / plain / library times and the bound, C and Z, at
    80^3 (the paper's largest), 512^3 and 2048^3, NN, operands warm in L2
    as in the paper's repeated same-size benchmark (2048^3 Z is 201 MB, past
    it).  The kernel time is ``api.gemm`` under the forced kernel (the
    plan, all its launches); the library call is ``torch.matmul`` on the
    complex tensors (TF32 off), timed here only.  The bound counts the
    Karatsuba's 6MNK + 5MN operations at the plane type's peak
    (``cost.gemm_roofline``).  The line's numbers are C at 80^3."""
    from repro_torch import api
    from repro_torch.core import cost, kernelgen, plan as plan_mod
    from repro_torch.kernels import iaat_gemm
    kern = api.Policy(backend="kernel")
    g = torch.Generator(device="cuda").manual_seed(17)
    rows = []
    for letter in ("C", "Z"):
        sig = kernelgen.kernel_table(letter, "NN")[0]
        for n in (80, 512, 2048):
            a = _grid_operand(torch, g, (n, n), letter)
            b = _grid_operand(torch, g, (n, n), letter)
            want = iaat_gemm.gemm_region_plain(sig, a, b)
            ab, rel = _rel_err(api.gemm(a, b, policy=kern), want)
            _, lib_rel = _rel_err(torch.matmul(a, b), want)
            if not rel <= GRID_TOL[letter]:
                raise AssertionError(f"complex kernel {letter} {n}^3: rel "
                                     f"err {rel}")
            reps = 50 if n < 1024 else 10
            t_k = _time_ms(torch, lambda i: api.gemm(a, b, policy=kern),
                           reps)
            t_p = _time_ms(torch, lambda i: iaat_gemm.gemm_region_plain(
                sig, a, b), reps)
            t_l = _time_ms(torch, lambda i: torch.matmul(a, b), reps)
            bound = cost.gemm_roofline(n, n, n, letter)
            p = plan_mod.build_plan(n, n, n, letter, "NN")
            row = {"letter": letter, "n": n, "ms": t_k, "plain_ms": t_p,
                   "library_ms": t_l, "bound_ms": bound.seconds * 1e3,
                   "bound_by": bound.bound, "flops": bound.flops,
                   "bytes": bound.hbm_bytes,
                   "launches_per_call": p.num_kernel_calls,
                   "blocks": [r.sig.name for r in p.regions],
                   "max_abs_err": ab, "library_rel_err": lib_rel}
            rows.append(row)
            log(f"kernel time cx_gemm {letter} {n}^3: kernel {t_k:.4f} ms "
                f"({p.num_kernel_calls} launches: {row['blocks']}), plain "
                f"{t_p:.4f} ms, library (torch.matmul) {t_l:.4f} ms (rel "
                f"err vs plain {lib_rel:.3g}), bound "
                f"{row['bound_ms']:.5f} ms ({bound.bound}: "
                f"{bound.flops / 1e9:.4f} GFLOP, {bound.hbm_bytes / 1e6:.3f} "
                f"MB), {bound.flops / t_k / 1e9:.2f} TFLOP/s; kernel vs "
                f"plain rel err {rel:.3g}")
    main = rows[0]
    entry = {
        "name": "cx_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cx_gemm.cu",
        "replaces": "src/repro/kernels/iaat_gemm.py:152",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "at": "C (complex64) 80x80x80 NN through api.gemm under the forced "
              "kernel, the paper's largest small GEMM; launches: the grid "
              "check's C/Z GEMMs",
        "more": {f"{r['letter']}{r['n']}": {
            k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by", "launches_per_call")}
            for r in rows},
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
    mcfg = configs.get_config(MOE_ARCH)
    MAIN_SHAPES[:] = [(cfg.d_model, cfg.d_model, False),
                      (cfg.d_model, cfg.d_ff, False),
                      (cfg.d_ff, cfg.d_model, False),
                      (cfg.d_model, cfg.vocab_padded, True)]
    GRID_DT.update({"S": torch.float32, "D": torch.float64,
                    "C": torch.complex64, "Z": torch.complex128})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)}
    phase_s = report["phase_seconds"] = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    try:
        report["card"] = timed("card", phase_card)
        report["flash_build"] = timed("build", phase_build)
        max_err = timed("check", phase_check, torch)
        report["grid_check"] = timed("grid check", phase_grid_check, torch)
        report["pack"] = timed("pack baseline", phase_pack, torch)
        report["flash_check"] = timed("flash check", phase_flash_check,
                                      torch)
        report["serve"], params = timed("serve", phase_serve, torch,
                                        "olmo-1b", cfg, 6, 16, ["iaat_gemm"])
        report["step"] = timed("step", phase_step, torch, cfg, params)
        report["wave_serve"] = timed("wave serve", phase_wave_serve, torch,
                                     cfg, params)
        report["wave_step"] = timed("wave step", phase_wave_step, torch,
                                    cfg, params)
        del params
        torch.cuda.empty_cache()
        grouped_err, ragged_launches = timed("grouped check",
                                             phase_grouped_check, torch, mcfg)
        report["moe_serve"], params = timed(
            "moe serve", phase_serve, torch, MOE_ARCH, mcfg, 5, 8,
            ["batched_gemm", "iaat_gemm"])
        report["moe_step"] = timed("moe step", phase_step, torch, mcfg,
                                   params)
        del params
        torch.cuda.empty_cache()
        entry, rows = timed("kernels", phase_kernels, torch, cfg,
                            report["serve"]["auto"]["launches"], max_err)
        launches = {"batched_gemm": report["moe_serve"]["auto"]["launches"],
                    "ragged_gemm": ragged_launches}
        grouped, grouped_rows = timed("grouped kernels",
                                      phase_grouped_kernels, torch, mcfg,
                                      launches, grouped_err)
        wave = report["wave_serve"]["auto"]
        flash, flash_rows = timed(
            "flash kernels", phase_flash_kernels, torch, cfg,
            tuple(wave["prefill_shapes"][0]),
            wave["launch_counts"]["flash_attention"])
        report["tune"] = timed("tune", phase_tune, torch, mcfg)
        grid = report["grid_check"]
        cx, cx_rows = timed(
            "complex kernels", phase_complex_kernels, torch,
            grid["launches"]["cx_gemm"],
            max(grid["max_abs_err"]["C"], grid["max_abs_err"]["Z"]))
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    report["kernels"] = [entry] + grouped + [flash, cx]
    report["shapes"] = rows + grouped_rows + flash_rows + cx_rows
    report["seconds"] = time.perf_counter() - t_start
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"chip_smoke: all phases passed in {report['seconds']:.1f}s: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in phase_s.items()))
    print(json.dumps({"kernels": report["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
