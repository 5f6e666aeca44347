"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout; builds the port's CUDA kernels from the
sources there (into build/repro_torch/), then, in phases, each of which
fails the run:

1. card   — prints ``nvidia-smi --query-gpu=name,power.limit`` as is;
2. build  — compiles every instance of the kernel table, for the IAAT
            GEMM and the two grouped kernels, and the flash attention
            instances (ptxas must report all);
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
            the wave's prefill shape and at B 1 x 16 heads x S 2048 x D 128.

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
                        "ragged_gemm_kernel", "flash_attention_kernel")}
    log(f"build: {n} instances x {len(build.SOURCES)} sources + "
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
    want = len(kernelgen.instances())
    want_flash = 2 * len(flash_attention.HEAD_DIMS)
    if len(regs) != 3 * want + want_flash or len(flash) != want_flash or \
            any(per[k] != want for k in per if k != "flash_attention_kernel"):
        raise RuntimeError("ptxas reported another kernel count than the "
                           f"table's {want} instances per GEMM kernel and "
                           f"{want_flash} flash instances")
    return flash


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
    return {"iaat_gemm": iaat_gemm.launch_count(),
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
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    report["kernels"] = [entry] + grouped + [flash]
    report["shapes"] = rows + grouped_rows + flash_rows
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
