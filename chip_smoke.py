"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout; builds the port's CUDA kernels from the
sources there (into build/repro_torch/), then, in phases, each of which
fails the run:

1. card   — prints ``nvidia-smi --query-gpu=name,power.limit`` as is;
2. build  — compiles every instance of the kernel table, for the IAAT
            GEMM (three load paths) and the grouped kernels (S/D/H, two
            load paths), the complex Karatsuba kernel (C/Z), and the flash
            attention instances (ptxas must report all; cuobjdump's SASS of
            the tensor-core flash instances must hold HGMMA, that of the
            bf16 grouped ring instances HMMA.16816.F32.BF16, that of
            the S, D and bf16 scalar grouped instances no HMMA, that of
            every Z complex function DMMA and that of the C one no HMMA);
3. check  — the CUDA IAAT kernel against its plain PyTorch version, on
            the card, for S/H/D x NN/NT/TN/TT, K tails, M/N overhangs,
            alpha/beta with and without C, and olmo-1b's main-path shapes;
            GEMMs of mixed operand dtypes (a bf16 or f64 C of an S GEMM,
            an f32 C of an H GEMM, real x complex) against f64; split-K
            regions (K tails, beta with C, B read along N and along K,
            unaligned and strided views on the scalar path), each case's
            load path and split asserted from the per-path launch counts,
            and that olmo-1b's decode shapes split K on the cp.async ring;
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
            {1, 8, 9, 16, 30}, K tails (70, 136) and N overhangs (1408,
            320), ragged with empty groups and row tiles of 8 (under the
            16-row grain), 16 and 128, every table instance on both load
            paths, unaligned and strided views, and moonshot's decode
            shapes; every launch's path (cp.async ring or scalar), K split
            and bf16 mma asserted from the per-path counts, each of the
            four taken at least once, and the decode shapes on the mma
            ring (one token's ragged layout also split);
7. moe serve — olmo's weights freed, moonshot-v1-16b-a3b at full width
            and full depth (48 layers, 64 experts top-6, bf16, 56 GB of
            random weights) serves 5 requests (after an uncounted warm-up)
            under ``auto`` and under the forced kernel; both the grouped
            and the IAAT kernel's launch counts must be > 0 under both,
            and every expert GEMM a batched launch on the mma ring;
8. moe step — one full-width decode step, kernel against the plain
            arithmetic, logits compared, and the share of (token, layer)
            expert choices the two runs agree on;
9. kernels — times at the main-path shapes (olmo's 2-D GEMMs, moonshot's
            grouped ones: loop and torch.profiler device times of kernel,
            plain and library, and the ragged kernel over a sweep of
            grids and K slices), printed as the ``kernels`` JSON line; for one
            olmo-1b decode step's GEMMs also the step's loop time, its
            torch.profiler device time and a CUDA-graph replay;
10. flash check — the CUDA flash attention kernels (bf16 at D 64/128/256
            on the tensor cores, the rest on the CUDA cores; both must
            launch) against their plain version, f32 and bf16: B in {1, 3}, (Hq, Hkv) in {(16, 16),
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
13. flash kernels — flash kernel / plain / SDPA times (loop and device)
            and the bound at the wave's prefill shape, at B 1 x 16 heads x
            S 2048 x D 128 and at B 1 x 8 heads x S 2048 x D 256;
14. grid check — the paper's grid (configs/paper_gemm.py: S/D/C/Z x
            NN/NT/TN/TT, M = N = K = 2..80, to 32 for TN), ragged
            non-cubes, .T and sliced views, alpha (complex for C/Z) with
            and without C, through api.gemm under the forced kernel, each
            output finite and within the reference's _RTOL of the plain
            version; counted from 0, the real and the complex kernel must
            both launch, every complex call exactly once (one launch a
            plan; run right after phase 3);
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
17. complex kernels — the complex kernel / plain / torch.matmul loop
            and torch.profiler device times and the bound for C and Z at
            80^3, 512^3 and 2048^3, with the launches of one call (run
            before phase 16, the last: after the tune's sweep a trace
            drops its first kernels);
18. ssd check — the CUDA SSD scan against its plain version, f32 and bf16:
            Bt in {1, 3}, S in {1, 17, 100, 128, 300, 2048}, every chunk
            instance (16, 32, 64, 128), mamba2's smoke (N 16, P 8) and full
            (N 128, P 64) widths and N 20, P 12 (P held padded to 16 on
            the card), x, B and C as the strided views the
            model cuts from its conv output; launches and scans counted
            apart, each case one scan of ssd.launches_per_scan launches
            (run after phase 10);
19. ssm serve — the earlier models' weights freed, mamba2-780m at full
            width and full depth (48 layers, bf16, random weights) serves
            6 requests through PagedEngine (after an uncounted warm-up)
            under ``auto`` and under the forced kernel: IAAT launches > 0
            under both, SSD launches 0 (serving runs the token-by-token
            recurrence, as in the reference);
20. ssm forward — one forward_train over 2 x 2048 tokens, through the
            kernels (``kernel``: 48 SSD scans of 3 launches exactly), under
            ``auto`` (timed; the scans on the kernel) and through the
            plain arithmetic (``library``: ref.ref_ssd), logits compared;
            then the same with the weights widened to f32, held tighter;
21. ssd kernels — SSD kernel / plain / ref.ref_ssd loop and
            torch.profiler device times, launches per scan and two bounds
            (C Bᵀ counted once a batch and chunk, and once a head) at the
            forward's shape (f32, as the model passes it);
22. concurrent split — olmo-1b's four decode shapes (M = 4; K split on
            the ring but for the tied vocabulary head, whose grid fills
            the card) and one moonshot batched_gemm decode call on two
            streams at once, six times over, each against its plain
            version; the split launches counted per stream, one ticket
            array a stream (run after phase 3);
23. online serve — olmo-1b at full width under ``tuned`` with the online
            tuner (launch.serve.serve(online_tune=True, trace=...)), from
            an empty profile: at least one cycle between the engine's
            steps and one swap, merged online entries with finite kernel
            times, every request done, every step under one profile
            generation; then the same
            requests with no tuner (tok/s of both, requests whose bf16
            tokens differ); then olmo-smoke in f32 with manual swaps
            between steps, token-identical to a run with none (run after
            phase 12);
24. trace — the serve's Perfetto file: a track per slot, flow-linked
            request slices, a tuner track with tune_cycle slices, and
            ``python -m repro_torch.obs trace IN OUT`` re-exporting it
            identically; the per-request summary (queue wait, TTFT p50 /
            p99, decode stall);
25. online grouped — one synchronous OnlineTuner.cycle() on the traffic
            the moonshot serve left in ROUTES: at least one grouped:
            entry re-timed on the card (run after phase 7);
26. gemma3 — gemma3-1b at full width and depth (26 layers, 16 padded
            heads of 256, 5:1 local:global with window 512, a tied
            262144-entry vocabulary) on PagedEngine and on the wave
            ContinuousBatcher under ``auto`` and the forced kernel, one
            1100-token wave prompt past the window; a paged decode step
            and the long prompt's prefill and decode steps against the
            plain arithmetic; flash launches at D 256 and the vocabulary
            head's IAAT launches counted;
27. dense — glm4-9b and smollm-360m at full width and depth on
            PagedEngine under both policies, a decode step each against
            the plain arithmetic;
28. mixtral — mixtral-8x22b at full width and 4 of its 56 layers (the
            rest does not fit the card) on PagedEngine, every expert GEMM
            a batched launch on the mma ring; a decode step against the
            plain arithmetic;
29. zamba2 — zamba2-7b at full width and depth (81 mamba layers, the
            shared attention block applied 14 times) on PagedEngine (no
            SSD or flash launch while serving), then forward_train over 2
            x 2048 tokens under ``auto`` (81 SSD scans, 14 flash launches
            at D 112 padded to 128 on the tensor cores) against the plain
            arithmetic, in bf16 and with the weights widened to f32;
30. vlm   — internvl2-2b at full width: a short paged serve of text, then
            one prefill of 1024 fake_frontend embeddings and a 64-token
            prompt and 4 decode steps under ``auto`` against the plain
            arithmetic;
31. slice kernels — the IAAT kernel on gemma3's vocabulary head and
            glm4's projections at M 4, flash at gemma3's D 256 / window
            512 and zamba2's D 112, batched_gemm at mixtral's experts and
            the SSD scan at zamba2's d_state 64: kernel, plain and library
            times (loop and device) and the bound, attached to the
            ``kernels`` line's entries as ``slice_shapes``;
32. forward — olmo-1b's forward_train over 2 x 2048 tokens under
            ``auto`` (16 flash launches, causal, on the tensor cores)
            against the plain arithmetic, logits within 5 %, aux 0 (run
            after phase 24, on phase 4's weights);
33. moe forward — moonshot-v1-16b-a3b's forward_train over 1 x 2048
            under ``auto`` (48 flash launches; batched_gemm launches as
            api.route sends the forward's expert GEMMs), its aux loss
            within 1e-3 of the plain run's, the logits held block by
            block with the plain MoE pinned to the expert choices (run
            after phase 8, on phase 7's weights);
34. encdec — seamless-m4t-large-v2 at full width and depth (24 encoder
            and 24 decoder layers, d 1024, vocab 256256) through
            registry.build's prefill and decode: greedy decoding of 4
            requests (1000 frames, 4 prompt tokens, 32 new) and of 1
            under ``auto``, 1 for 4 steps under the forced kernel; flash
            launches 24 an encode, 72 a prefill, 24 a decode step (the
            cross attention at Sq = 1), all tensor-core; IAAT launches > 0
            a decode step, all on the ring; bf16 prefill and decode step
            against the plain arithmetic within 5 % (whole stack or
            block by block); then the weights widened to f32: greedy
            logits within 1e-4 of the library's, tokens identical, and
            forward_train of 33 tokens consistent with prefill of 32 and
            one decode step within 1e-4 (run after phase 30);
35. encdec kernels — the IAAT kernel at seamless's decode GEMMs (M 4),
            flash at its cross attention (Sq 1 against 1000 keys) and
            encoder (1000 x 1000), non-causal, and at olmo's forward
            (causal, B 2 x S 2048), batched_gemm at moonshot's forward
            capacity: kernel, plain and library times and the bound,
            added to ``slice_shapes``;
36. encdec step — one seamless decode step at B 4 under ``auto``: loop
            time and torch.profiler device time (run after phase 17, the
            last other device-time phase, and before phase 16);
37. train — olmo-1b at full width and depth (f32 master, bf16 compute)
            through launch.train.run for 8 steps of 4 x 64 tokens under
            ``auto`` with the non-GEMM kernels pinned to the library
            (Policy.kernels), on the launcher's 1 x 1 host mesh (a
            one-rank NCCL group), its rules and activation context, and
            remat "full": exactly TRAIN_IAAT_PER_STEP = 128 IAAT launches
            in every step (q/k/v/o at M 256, 64 in the forward and 64
            again in the recompute of each checkpointed layer; the
            backward's adjoint GEMMs go to the library), no flash,
            grouped or SSD launch, every loss, grad norm and lr finite,
            the lr the schedule's; then one step from one seeded state and batch
            under ``auto``, the forced kernel and the library (times and
            IAAT launches of each), kernel against library within
            TRAIN_TOL in bf16 and with the weights widened to f32 (run
            after phase 32, once the served weights are freed);
38. train restart — olmo-1b at full width and 2 of its 16 layers: twice
            uninterrupted, then with asynchronous checkpoints (the
            reference's format, into a temporary directory under build/)
            and a fault at step 5, restored from step 4: the final state
            (params, m, v), leaf for leaf, and the losses no further from
            the uninterrupted run's than the two uninterrupted runs are
            from each other (0 on the H100: bit for bit);
39. ssm train — mamba2-780m at full width and depth, 3 steps of 2 x 64
            tokens under ``auto`` on the host mesh with remat "full":
            exactly SSM_TRAIN_IAAT_PER_STEP = 288 IAAT launches in every
            step, all of them at in_proj (128 x 1536 x 6448, 2 regions)
            and out_proj (128 x 3072 x 1536), counted by shape: 3 a layer
            in the forward and 3 again in the recompute (out_proj, the
            layer's last GEMM, runs again though the recompute stops
            right after it: the IAAT kernel's autograd Function saves
            its inputs after its forward); the SSD scan through
            ref.ref_ssd under autograd (no SSD launch);
40. train kernels — the IAAT kernel at the train phase's q/k/v/o shape
            (256 x 2048 x 2048) and at mamba2's in_proj and out_proj
            train shapes (bf16), each held against its plain version:
            kernel, plain and library times and the bound, added to
            ``slice_shapes`` with the train phases' launches at that
            shape (run after phase 35);
41. train profile — one warm olmo-1b train step under ``auto``: wall
            time, the same step cut at its three parts (the cast, forward
            and backward, AdamW; each to a synchronize, on the one
            state), and a torch.profiler trace's device time by group
            (the IAAT kernel, the library's GEMMs, the rest) and the
            device's idle share (run after phase 36, the last other
            trace, and before phase 16);
42. moe shards — moonshot-v1-16b-a3b at full width and depth (the
            "moe serve" weights): layer 0's MoE on 2048 tokens under
            ``_moe_shards`` = 8 (the per-data-shard branch: eight
            dispatch groups of 256 tokens, the expert FFN on the
            (8, E, C, d) buffer) against eight one-shard calls on the
            256-token slices, their expert choices pinned to the
            sharded run's: bf16 within MOE_SHARD_TOL["bfloat16"], the
            layer's weights widened to f32 within MOE_SHARD_TOL
            ["float32"], of the largest output; then forward_train of
            1 x 2048 tokens under ``auto`` at 8 groups and at 1: 48
            flash launches each, finite logits (run after phase 29);
43. dryrun — the dry-run CLI (launch/dryrun.py, started in a CPU-only
            subprocess after phase 2) for olmo-1b and moonshot-v1-16b-a3b
            x train_4k and decode_32k x the 16 x 16 and 2 x 16 x 16
            meshes on the meta device: all 8 cells ok, and each cell's
            per-device argument bytes those of the reference
            (DRYRUN_BYTES; the cache less the reference's 4-byte device
            ``pos``, which the port keeps on the host); then the anchor,
            olmo-1b at B 4 x S 64 on the 1 x 1 mesh under ``library``:
            the dry run's train-state bytes within 1 % of the change of
            torch.cuda.memory_allocated() across init_train_state on the
            card, the step counter's matmul FLOPs of one train step on
            meta equal to the same counter's around a real step on the
            card, and the real step's time beside the roofline's step_s
            (printed; run after phase 41).
Phase 37 also prints the share of outputs of the IAAT kernel equal to
the bit to torch.matmul's at the train step's GEMM shapes (a reading,
not a check).
Phase 10 also holds head dims 20 and 112 (zero-padded to 32 and 128)
and non-causal attention with Sq != Sk (1, 4, 33 and 1000 queries
against 1000 keys: cross attention and the encoder) against the plain
version, and phase 23 times each installed online verdict again on the
idle card: it fails where the installed path takes 1.25 times the other
path's time or more.

The last line is {"ok": true, "device": {...}}; it is printed only when
every phase passed.  Without CUDA, or without the repository around it,
the script exits non-zero and prints no result.
"""
import contextlib
import itertools
import json
import math
import pathlib
import subprocess
import sys
import tempfile
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
SSM_ARCH = "mamba2-780m"
#: the same full-width forward_train with its weights widened to f32:
#: kernel and plain then take the same products in f32, summed in other
#: orders over 48 layers; held to 1e-4 of the largest logit
FWD_F32_TOL = 1e-4


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
    from repro_torch.kernels import build, flash_attention, ssd
    import re
    t0 = time.perf_counter()
    n = kernelgen.install()
    lib = build.build()         # already built: returns its path
    ptx = (lib.parent / "ptxas.log").read_text()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "ptxas.log").write_text(ptx)   # registers, spills per kernel
    job_s = json.loads((lib.parent / "build_seconds.json").read_text())
    log("build: nvcc jobs' wall seconds, slowest first: " + ", ".join(
        f"{k} {v}" for k, v in sorted(job_s.items(), key=lambda kv: -kv[1])))
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", ptx)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", ptx))
    per = {name: len(re.findall(rf"Compiling entry function '\w*{name}",
                                ptx))
           for name in ("iaat_gemm_kernel", "grouped_gemm_kernel",
                        "cx_gemm_kernel",
                        "flash_attention_kernel", "flash_attention_tc_kernel",
                        "ssd_state_kernel", "ssd_pass_kernel",
                        "ssd_out_kernel")}
    real = sum(1 for i in kernelgen.instances()
               if i[0] in kernelgen.KERNEL_LETTERS)
    cx = n - real
    log(f"build: {real} real instances x ({len(build.IAAT_PATHS)} IAAT "
        f"paths + {len(build.GROUPED_PATHS)} grouped paths) + "
        f"{cx} complex x {len(build.SOURCES_CX)} + "
        f"{len(build.SOURCES_ONCE)} once in "
        f"{time.perf_counter() - t0:.1f}s, {len(regs)} kernels "
        f"{json.dumps(per)}, max {max(regs)} registers, {spills} bytes "
        f"spill stores -> {lib}")
    # the flash instances: (kernel, dtype, head dim) from the mangled name
    flash = []
    for entry in ptx.split("Compiling entry function")[1:]:
        # the entry's own name (a warning line may name another kernel)
        name = entry.split("'")[1]
        m = re.search(r"flash_attention_kernelI(\w+?)Li(\d+)E", name)
        mt = re.search(r"flash_attention_tc_kernelILi(\d+)E", name)
        if m or mt:
            flash.append({
                "kernel": "tc" if mt else "cuda_core",
                "dtype": "bf16" if mt or "bfloat16" in m.group(1) else "f32",
                "D": int((mt or m).group(1 if mt else 2)),
                "registers": int(re.search(r"Used (\d+) registers",
                                           entry).group(1)),
                "spill_stores": int(re.search(
                    r"(\d+) bytes spill stores", entry).group(1))})
    flash.sort(key=lambda f: (f["kernel"], f["dtype"], f["D"]))
    log("build: flash_attention instances (registers, spill bytes): "
        + ", ".join(f"{f['kernel']} {f['dtype']} D{f['D']} "
                    f"{f['registers']}/{f['spill_stores']}" for f in flash))
    # f32 at every head dim and bf16 under the tensor-core dims on the
    # CUDA cores; bf16 at the tensor-core dims on wgmma
    n_tc = len(flash_attention.TC_HEAD_DIMS)
    want_flash = 2 * len(flash_attention.HEAD_DIMS) - n_tc
    want_ssd = 2 * len(ssd.CHUNKS)
    # one complex kernel a letter, over every instance of its table
    want = {"iaat_gemm_kernel": len(build.IAAT_PATHS) * real,
            "grouped_gemm_kernel": len(build.GROUPED_PATHS) * real,
            "cx_gemm_kernel": len(kernelgen.COMPLEX_LETTERS),
            "flash_attention_kernel": want_flash,
            "flash_attention_tc_kernel": n_tc,
            "ssd_state_kernel": want_ssd, "ssd_pass_kernel": 1,
            "ssd_out_kernel": want_ssd}
    if len(regs) != sum(want.values()) or \
            len(flash) != want_flash + n_tc or per != want:
        raise RuntimeError("ptxas reported another kernel count than the "
                           f"table's {want}: {per}")
    hgmma, hgmma_line = flash_sass(lib.parent / "flash_attention.o", n_tc)
    hmma, hmma_line = grouped_sass(lib.parent, real)
    dmma, dmma_line = cx_sass(lib.parent)
    # the grouped instances: registers and spills per path and letter
    gr = {}
    for e in ptx.split("Compiling entry function")[1:]:
        name = e.split("'")[1]
        if "grouped_gemm_kernel" not in name:
            continue
        # the mangled template arguments: type, BM, BN, BK, path
        m = re.search(r"grouped_gemm_kernelI(\w+?)Li(\d+)ELi(\d+)ELi(\d+)"
                      r"ELi([01])E", name)
        dt = {"f": "S", "d": "D"}.get(m.group(1), "H")
        mode = build.GROUPED_PATHS[int(m.group(5))]
        r = int(re.search(r"Used (\d+) registers", e).group(1))
        sp = int(re.search(r"(\d+) bytes spill stores", e).group(1))
        gr[f"{dt} {mode} {m.group(2)}x{m.group(3)}x{m.group(4)}"] = (r, sp)
    log("build: grouped_gemm instances (registers/spill bytes): "
        + ", ".join(f"{k} {r}/{sp}" for k, (r, sp) in sorted(gr.items())))
    # the complex and SSD kernels: registers and spills, from the ptxas
    # report
    def regs_of(kernel):
        out = {}
        for e in ptx.split("Compiling entry function")[1:]:
            name = e.split("'")[1]
            m = re.search(rf"{kernel}I(\w+?)(Li(\d+)E)?EEv", name)
            if kernel not in name:
                continue
            key = (m.group(1) if m else name)[:12] + (
                f" {m.group(3)}" if m and m.group(3) else "")
            out[key] = (int(re.search(r"Used (\d+) registers",
                                      e).group(1)),
                        int(re.search(r"(\d+) bytes spill stores",
                                      e).group(1)))
        return out
    cxr = regs_of("cx_gemm_kernel")
    ssdr = {k: regs_of(k) for k in ("ssd_state_kernel", "ssd_pass_kernel",
                                    "ssd_out_kernel")}
    log("build: cx_gemm kernels (registers/spill bytes): " + ", ".join(
        f"{k} {r}/{sp}" for k, (r, sp) in sorted(cxr.items())))
    log("build: ssd kernels (registers/spill bytes): " + "; ".join(
        f"{k}: " + ", ".join(f"{i} {r}/{sp}" for i, (r, sp) in
                             sorted(v.items()))
        for k, v in ssdr.items()))
    return {"flash_instances": flash, "hgmma": hgmma,
            "hgmma_line": hgmma_line, "grouped_hmma": hmma,
            "grouped_hmma_line": hmma_line, "grouped_registers": gr,
            "cx_dmma": dmma, "cx_dmma_line": dmma_line,
            "cx_registers": cxr, "ssd_registers": ssdr}


def flash_sass(obj, n_tc):
    """``cuobjdump -sass`` of the flash object: every tensor-core instance
    must hold HGMMA instructions (Hopper's wgmma) and the CUDA-core ones
    none; the count per function and one HGMMA line are logged."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    (OUT_DIR / "flash_sass.txt").write_text(sass)
    counts, line = {}, None
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        hg = [ln for ln in fn.splitlines() if "HGMMA" in ln]
        counts[name] = len(hg)
        if hg and line is None:
            line = re.sub(r"\s+", " ", hg[0]).strip()
    tc = {k: v for k, v in counts.items() if "flash_attention_tc_kernel" in k}
    other = {k: v for k, v in counts.items() if k not in tc}
    log(f"build: cuobjdump -sass flash_attention.o: HGMMA per function "
        f"{json.dumps(counts)}; e.g. {line}")
    if len(tc) != n_tc or not all(tc.values()) or any(other.values()):
        raise AssertionError(f"flash SASS: HGMMA counts {counts}")
    return counts, line


def grouped_sass(build_dir, real):
    """``cuobjdump -sass`` of the grouped objects, one per letter and
    path: every function of the H ring object must hold
    HMMA.16816.F32.BF16 (mma.sync m16n8k16 on bf16), and no function of
    the S and D objects (f32 and f64 FMAs, so S never runs as TF32) or of
    the H scalar object may hold any HMMA.  The HMMA count per object and
    one HMMA line are logged, the counts per function in
    chiprun_out/grouped_sass.txt."""
    import re
    import shutil
    from repro_torch.core import kernelgen
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts, line, fns, kept = {}, None, 0, []
    # the six disassemblies run side by side, each into a file of its own
    tmp = pathlib.Path(tempfile.mkdtemp(dir=build_dir))
    procs = {}
    for letter in kernelgen.KERNEL_LETTERS:
        for path in build.GROUPED_PATHS:
            name = f"grouped_gemm_{letter}_{path}"
            with open(tmp / f"{name}.sass", "w") as out:
                procs[(letter, path)] = subprocess.Popen(
                    [tool, "-sass", str(build_dir / f"{name}.o")],
                    stdout=out, stderr=subprocess.STDOUT)
    try:
        for proc in procs.values():
            proc.wait(timeout=300)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for (letter, path), proc in procs.items():
        sass = (tmp / f"grouped_gemm_{letter}_{path}.sass").read_text()
        if proc.returncode:
            raise RuntimeError(f"cuobjdump grouped_gemm_{letter}_{path}.o: "
                               f"{sass[-2000:]}")
        per = []
        for fn in sass.split("Function : ")[1:]:
            hm = [ln for ln in fn.splitlines() if "HMMA" in ln]
            want = [ln for ln in hm if "HMMA.16816.F32.BF16" in ln]
            per.append((len(hm), len(want)))
            kept.append(f"{letter} {path} {fn.split(chr(10), 1)[0]}: "
                        f"{len(hm)} HMMA, {len(want)} "
                        "HMMA.16816.F32.BF16")
            if want and line is None:
                line = re.sub(r"\s+", " ", want[0]).strip()
        fns += len(per)
        counts[f"{letter} {path}"] = [sum(h for h, _ in per),
                                      min((w for _, w in per),
                                          default=0)]
        tc = letter == "H" and path == "ring"
        if not per or (tc and not all(w for _, w in per)) or \
                (not tc and any(h for h, _ in per)):
            raise AssertionError(f"grouped SASS {letter} {path}: (HMMA, "
                                 f"HMMA.16816.F32.BF16) per function "
                                 f"{per}")
    shutil.rmtree(tmp)
    if fns != len(build.GROUPED_PATHS) * real:
        raise AssertionError(f"grouped SASS: {fns} functions, want "
                             f"{len(build.GROUPED_PATHS) * real}")
    (OUT_DIR / "grouped_sass.txt").write_text("\n".join(kept) + "\n")
    log("build: cuobjdump -sass grouped_gemm_<letter>_<path>.o: [HMMA in "
        "all, fewest HMMA.16816.F32.BF16 in one function] "
        f"{json.dumps(counts)}; e.g. {line}")
    return counts, line


def cx_sass(build_dir):
    """``cuobjdump -sass`` of the complex objects, one per letter: every
    function of the Z object must hold DMMA (mma.sync .f64 on the f64
    tensor cores), and no function of the C object any HMMA or DMMA (f32
    FMAs, never TF32).  The counts per function go to
    chiprun_out/cx_sass.txt; one DMMA line is logged."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts, line, kept = {}, None, []
    for letter in ("C", "Z"):
        sass = subprocess.run(
            [tool, "-sass", str(build_dir / f"cx_gemm_{letter}.o")],
            capture_output=True, text=True, timeout=300, check=True).stdout
        per = []
        for fn in sass.split("Function : ")[1:]:
            dm = [ln for ln in fn.splitlines() if "DMMA" in ln]
            hm = [ln for ln in fn.splitlines() if "HMMA" in ln]
            per.append((len(dm), len(hm)))
            kept.append(f"{letter} {fn.split(chr(10), 1)[0]}: {len(dm)} "
                        f"DMMA, {len(hm)} HMMA")
            if dm and line is None:
                line = re.sub(r"\s+", " ", dm[0]).strip()
        counts[letter] = per
        bad = (not per or any(h for _, h in per) or
               (letter == "Z" and not all(d for d, _ in per)) or
               (letter == "C" and any(d for d, _ in per)))
        if bad:
            raise AssertionError(f"cx SASS {letter}: (DMMA, HMMA) per "
                                 f"function {per}")
    (OUT_DIR / "cx_sass.txt").write_text("\n".join(kept) + "\n")
    log(f"build: cuobjdump -sass cx_gemm_<letter>.o: (DMMA, HMMA) per "
        f"function {json.dumps(counts)}; e.g. {line}")
    return counts, line


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
    # operands of mixed dtype (DESIGN_PORT.md §6): a and b promoted, c at
    # the accumulator's precision, held against f64 / complex128
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    c64, c128 = torch.complex64, torch.complex128
    for da, db, dc, tol in ((f32, f32, bf16, TOL["S"]),
                            (f32, f32, f64, TOL["S"]),
                            (bf16, bf16, f32, TOL["H"]),
                            (f32, c64, c64, 2e-4), (c128, f64, None, 1e-12)):
        a = torch.randn((33, 70), generator=g, device="cuda").to(da)
        b = torch.randn((70, 50), generator=g, device="cuda").to(db)
        c = None if dc is None else torch.randn(
            (33, 50), generator=g, device="cuda").to(dc)
        n0 = iaat_gemm.launch_count()
        out = api.gemm(a, b, c, 1.5, 0.5, policy=kern)
        wide = c128 if out.is_complex() else f64
        want = 1.5 * (a.to(wide) @ b.to(wide))
        if c is not None:
            want = want + 0.5 * c.to(wide)
        torch.cuda.synchronize()
        _, rel = _rel_err(out, want)
        what = f"{da} x {db}, c {dc}"
        if out.dtype != torch.promote_types(da, db) or \
                iaat_gemm.launch_count() == n0 or not rel <= tol:
            raise AssertionError(f"mixed dtypes {what}: {out.dtype}, rel "
                                 f"err {rel} (tol {tol})")
        log(f"check mixed dtypes {what}: {out.dtype}, rel err {rel:.3g} "
            f"(tol {tol})")
    split_check(torch, g)
    main = {}
    for M in (4, 32):
        for (K, N, tied) in MAIN_SHAPES:
            x, (w,) = _main_operands(torch, g, M, K, N, tied)
            _reset_counts()
            out = api.matmul(x, w, policy=kern)
            want = iaat_gemm.gemm_region_plain(
                kernelgen.kernel_table("H", "NN")[0], x, w)
            torch.cuda.synchronize()
            n = _counts()
            ab, rel = _rel_err(out, want)
            main[(M, K, N, tied)] = ab
            slices = [r.slices for r in _plan_of(M, N, K).regions]
            log(f"check main path H M={M} K={K} N={N} tied={tied}: max abs "
                f"err {ab:.4g}, rel {rel:.3g} (tol {TOL['H']}); K slices "
                f"{slices}, launches ring {n['iaat_ring']} scalar "
                f"{n['iaat_scalar']} split {n['iaat_split']}")
            if not rel <= TOL["H"]:
                raise AssertionError(f"main-path shape {M}x{N}x{K}: {rel}")
            # every main-path GEMM loads through the ring; a grid that
            # underfills the card splits K
            if n["iaat_scalar"] or n["iaat_ring"] != len(slices) or \
                    n["iaat_split"] != sum(sl > 1 for sl in slices):
                raise AssertionError(f"main-path shape {M}x{N}x{K}: paths "
                                     f"{n}, K slices {slices}")
            if M == 4 and not tied and not n["iaat_split"]:
                raise AssertionError(f"decode shape K={K} N={N} did not "
                                     "split K")
    return max(main.values())


def _plan_of(M, N, K):
    """The plan api.matmul runs (NN flags; a tied weight is a .T view)."""
    from repro_torch.core import plan
    return plan.build_plan(M, N, K, "H", "NN")


def split_check(torch, g):
    """Split-K regions against the plain version: K not a multiple of
    slices x bk, beta != 0 with a c, the ring with B read along N and
    along K (a tied .T view), S/D/H, and strided or unaligned views that
    take the scalar path; each case's path and split are asserted from
    the per-path launch counts."""
    from repro_torch import api
    from repro_torch.core import kernelgen, plan
    from repro_torch.kernels import iaat_gemm
    kern = api.Policy(backend="kernel")
    dt = {"S": torch.float32, "D": torch.float64, "H": torch.bfloat16}

    def rnd(*shape, letter):
        return torch.randn(shape, generator=g, device="cuda").to(dt[letter])

    cases = []   # (what, letter, a, b, c, alpha, beta, trans_b, path)
    for letter in ("H", "S", "D"):
        K = 2085        # 33 steps of 64: not a multiple of slices x bk
        a = rnd(4, 2112, letter=letter)[:, :K]          # aligned rows
        b = rnd(K, 2048, letter=letter)
        c = rnd(4, 2048, letter=letter)
        cases.append((f"{letter} NN ring, K tail", letter, a, b, None, 1.0,
                      0.0, False, "ring"))
        cases.append((f"{letter} NN ring, beta c", letter, a, b, c, -0.75,
                      2.5, False, "ring"))
        e = rnd(1000, 2112, letter=letter)[:, :K]      # tied: embed (N, K)
        cases.append((f"{letter} NT ring along K (.T view)", letter, a, e,
                      None, 1.0, 0.0, True, "ring"))
        # unaligned: K of odd length rows; strided: every other column
        cases.append((f"{letter} NN scalar, unaligned rows", letter,
                      rnd(4, K, letter=letter), rnd(K, 1000, letter=letter),
                      rnd(4, 1000, letter=letter), 1.5, -0.5, False,
                      "scalar"))
        cases.append((f"{letter} NN scalar, strided views", letter,
                      rnd(4, 2 * K, letter=letter)[:, ::2],
                      rnd(K, 4096, letter=letter)[:, 1::2], None, 1.0, 0.0,
                      False, "scalar"))
    worst = {}
    for what, letter, a, b, c, alpha, beta, tb, path in cases:
        M, K = a.shape
        N = b.shape[0] if tb else b.shape[1]
        trans = "NT" if tb else "NN"
        slices = [r.slices for r in plan.build_plan(M, N, K, letter,
                                                    trans).regions]
        _reset_counts()
        out = api.gemm(a, b, c, alpha, beta, False, tb, policy=kern)
        want = iaat_gemm.gemm_region_plain(
            kernelgen.kernel_table(letter, trans)[0], a, b, c, alpha, beta)
        torch.cuda.synchronize()
        n = _counts()
        _, rel = _rel_err(out, want)
        worst[what] = rel
        if not rel <= TOL[letter]:
            raise AssertionError(f"split {what}: rel err {rel} > "
                                 f"{TOL[letter]}")
        if max(slices) < 2 or n[f"iaat_{path}"] != len(slices) or \
                n["iaat_split"] != sum(sl > 1 for sl in slices):
            raise AssertionError(f"split {what}: K slices {slices}, "
                                 f"launches {n}")
    log("check split K (ring and scalar paths): worst rel err "
        + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()}))
    return worst


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


#: IAAT launches made inside ``lm._unembed`` (the vocabulary head), counted
#: by the wrapper :func:`_count_vocab_head` installs
_HEAD = {"iaat": 0}
#: IAAT launches by the "MxKxN" of the ``api.matmul`` call that made
#: them (``_count_by_shape``)
_BY_SHAPE = {}


def _count_vocab_head():
    """Wraps ``lm._unembed`` so that the IAAT launches of the vocabulary
    head are counted apart (``_counts()["iaat_vocab_head"]``)."""
    from repro_torch.kernels import iaat_gemm
    from repro_torch.models import lm
    unembed = lm._unembed

    def counted(*a, **kw):
        n0 = iaat_gemm.launch_count("iaat_gemm")
        out = unembed(*a, **kw)
        _HEAD["iaat"] += iaat_gemm.launch_count("iaat_gemm") - n0
        return out
    lm._unembed = counted


def _count_by_shape():
    """Wraps ``api.matmul`` (every model projection goes through it) so
    that its IAAT launches are also counted by the call's (M, K, N)
    (``_BY_SHAPE``, "MxKxN" -> launches; zeroed by ``_reset_counts``)."""
    from repro_torch import api
    from repro_torch.kernels import iaat_gemm
    matmul = api.matmul

    def counted(x, w, **kw):
        n0 = iaat_gemm.launch_count("iaat_gemm")
        try:
            return matmul(x, w, **kw)
        finally:
            # also where the call raises after its launches: a recompute
            # that torch's checkpoint stops inside the last GEMM
            n = iaat_gemm.launch_count("iaat_gemm") - n0
            if n:
                key = f"{x.numel() // x.shape[-1]}x{w.shape[0]}x{w.shape[1]}"
                _BY_SHAPE[key] = _BY_SHAPE.get(key, 0) + n
    api.matmul = counted


def _reset_counts():
    """Every kernel's launch count and the Router's shape log to 0."""
    from repro_torch import obs
    from repro_torch.kernels import (flash_attention, grouped_gemm,
                                     iaat_gemm, ssd)
    _HEAD["iaat"] = 0
    _BY_SHAPE.clear()
    obs.ROUTES.reset()
    iaat_gemm.reset_launch_count()
    grouped_gemm.reset_launch_count()
    flash_attention.reset_launch_count()
    ssd.reset_launch_count()


def _counts():
    from repro_torch.kernels import (flash_attention, grouped_gemm,
                                     iaat_gemm, ssd)
    return {"iaat_gemm": iaat_gemm.launch_count("iaat_gemm"),
            "cx_gemm": iaat_gemm.launch_count("cx_gemm"),
            "batched_gemm": grouped_gemm.launch_count("batched_gemm"),
            "ragged_gemm": grouped_gemm.launch_count("ragged_gemm"),
            "flash_attention": flash_attention.launch_count(),
            "ssd_scan": ssd.launch_count(),
            "ssd_scans": ssd.scan_count(),
            # per kernel or path within the two redesigned wrappers
            "iaat_ring": iaat_gemm.path_count("ring"),
            "iaat_scalar": iaat_gemm.path_count("scalar"),
            "iaat_split": iaat_gemm.path_count("split"),
            "iaat_vocab_head": _HEAD["iaat"],
            "flash_tc": flash_attention.launch_count("flash_attention_tc"),
            "flash_cuda_core": flash_attention.launch_count(
                "flash_attention"),
            # both grouped kernels by path
            **{f"grouped_{p}": grouped_gemm.path_count(p)
               for p in ("ring", "scalar", "split", "mma")}}


def phase_serve(torch, arch, cfg, requests, max_new, kernels, params=None):
    """``arch`` (as ``cfg``: at full width, at the depth ``cfg`` has)
    serves ``requests`` prompts under ``auto`` and under the forced
    kernel, after an uncounted warm-up; every kernel in ``kernels`` must
    have launched in both runs.  Returns the runs' numbers and the weights
    (``params`` when given, else drawn from seed 0)."""
    from repro_torch import obs
    from repro_torch.launch import serve as serve_mod
    runs = {}
    # warm-up, not counted: weights, cuBLAS and allocator set-up, first
    # launches
    params = serve_mod.serve(arch, requests=1, max_new=2, backend="auto",
                             seed=0, device="cuda", cfg=cfg,
                             params=params)["params"]
    for backend in ("auto", "kernel"):
        _reset_counts()
        r = serve_mod.serve(arch, requests=requests, slots=4,
                            max_new=max_new, block_size=16, backend=backend,
                            seed=0, device="cuda", params=params, cfg=cfg)
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
        # a served model's activations and weights are 16-byte aligned:
        # every IAAT launch loads through the cp.async ring
        if launches["iaat_scalar"] or \
                launches["iaat_ring"] != launches["iaat_gemm"]:
            raise AssertionError(f"{arch} {backend}: IAAT launches off the "
                                 f"ring path: {launches}")
        # and every expert GEMM is a batched launch on the mma ring
        if "batched_gemm" in kernels and (
                launches["ragged_gemm"] or launches["grouped_scalar"] or
                launches["grouped_mma"] != launches["batched_gemm"]):
            raise AssertionError(f"{arch} {backend}: expert GEMMs off the "
                                 f"mma ring: {launches}")
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
                             s, n, n)
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


def _device_ms(torch, fn, reps, match=None, per_call=None):
    """Device time per call of ``fn`` from a torch.profiler trace of
    ``reps`` calls: the time of the trace's device kernels (those whose
    name holds ``match``, when given), summed, over ``reps``, and the
    count of such kernel launches.  A trace now and then comes back
    without its device events, or without the kernels that ran while it
    started (two of ten 2048^3 complex GEMMs, in one run), so a trace is
    taken again unless it holds ``per_call`` kernels a call (when given)
    or a whole number a call; (None, 0) if three traces fall short."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(i)
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for e in prof.key_averages():
            if not str(getattr(e, "device_type", "")).endswith("CUDA") or (
                    match is not None and match not in e.key):
                continue
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            if t > 0:
                us += t
                n += e.count
        if n and n % reps == 0 and per_call in (None, n // reps):
            return us / 1e3 / reps, n
    return None, 0


def _flash_bound(B, Hq, Hkv, S, D, window=None, Sq=None, causal=True):
    """(flops, bytes) of attention of Sq queries (default S) over S keys,
    only the (query, key) pairs the mask keeps (causal with the window,
    or every pair when ``causal`` is False): 4 D flops a pair and head;
    q and o of every q head, k and v of every KV head, each moved
    once."""
    Sq = S if Sq is None else Sq
    pairs = Sq * S if not causal else \
        sum(min(i + 1, window or S) for i in range(S))
    return 4 * D * pairs * B * Hq, 2 * 2 * B * D * (Sq * Hq + S * Hkv)


def _flash_row(torch, B, Hq, Hkv, S, D, window, what, Sq=None, causal=True):
    """Flash kernel / plain / library times (loop and device) and the
    bound at B x Hq heads (Hkv KV heads) x S x D, bf16, causal, with the
    window when given; or, with ``causal`` False, Sq queries (default S)
    against S keys, unmasked (cross attention, the encoder).  The library
    call is ``scaled_dot_product_attention``: ``is_causal`` without a
    window, the window as a boolean mask, no mask when not causal (the
    same function); timed here only, its output first compared with the
    plain version (logged).  The bound is :func:`_flash_bound`'s."""
    from repro_torch.core import cost
    from repro_torch.kernels import flash_attention as fa
    F = torch.nn.functional
    Sq = S if Sq is None else Sq
    g = torch.Generator(device="cuda").manual_seed(31)
    q = torch.randn((B, Hq, Sq, D), generator=g, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((B, Hkv, S, D), generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    i = torch.arange(S, device="cuda")
    keep = i[None, :] <= i[:, None]
    if window:
        keep &= i[None, :] > i[:, None] - window
    kw = dict(window=window, causal=causal)
    want = fa.flash_attention_plain(q, k, v, **kw)
    ab = _flash_err(torch, fa.flash_attention(q, k, v, **kw), want, what)

    def lib(i):
        # the causal mask alone as is_causal (SDPA's flash backend), a
        # window as a boolean mask, no mask for non-causal attention
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep if window else None,
            is_causal=causal and not window, enable_gqa=Hq != Hkv)
    _, lib_rel = _rel_err(lib(0), want)
    t = {"ms": _time_ms(torch, lambda i: fa.flash_attention(q, k, v, **kw),
                        20),
         "plain_ms": _time_ms(torch, lambda i: fa.flash_attention_plain(
             q, k, v, **kw), 5),
         "library_ms": _time_ms(torch, lib, 20),
         "device_ms": _device_ms(torch, lambda i: fa.flash_attention(
             q, k, v, **kw), 10, "flash_attention")[0],
         "library_device_ms": _device_ms(torch, lib, 10)[0]}
    flops, nbytes = _flash_bound(B, Hq, Hkv, S, D, window, Sq, causal)
    t_ops, t_bytes = flops / cost.PEAK_FLOPS_BF16, nbytes / cost.HBM_BW
    row = {"kernel": "flash_attention", "at": what, "B": B, "Hq": Hq,
           "Hkv": Hkv, "S": S, "Sq": Sq, "D": D, "window": window,
           "causal": causal, "launched_at_D": fa.padded_head_dim(D),
           "instance": fa.kernel_for(torch.bfloat16, fa.padded_head_dim(D)),
           **t, "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "flops": flops, "bytes": nbytes, "max_abs_err": ab,
           "library_rel_err": lib_rel}
    log(f"kernel time flash_attention {what}: B={B} Hq={Hq} Hkv={Hkv} "
        f"Sq={Sq} Sk={S} D={D} (launched at {row['launched_at_D']}, "
        f"{row['instance']}) causal {causal} window {window}: kernel "
        f"{t['ms']:.4f} ms (device "
        f"{t['device_ms']} ms), plain {t['plain_ms']:.4f} ms, SDPA "
        f"{t['library_ms']:.4f} ms (device {t['library_device_ms']} "
        f"ms, rel err vs plain {lib_rel:.3g}), bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}); max abs err {ab:.4g}")
    return row


def _iaat_row(torch, M, K, N, tied, what):
    """IAAT kernel (through ``api.matmul`` under the forced kernel) / plain
    / torch.matmul times (loop and device) and the bound at (M x K) @ (K
    x N), bf16, the weight (``tied``: an (N, K) embedding read through
    its .T view) cycled through enough copies (> 2 x the 50 MB L2) that
    every call reads it from HBM; the kernel's first call is held to the
    plain version and must take the cp.async ring."""
    from repro_torch import api
    from repro_torch.core import cost, kernelgen
    from repro_torch.kernels import iaat_gemm
    kern = api.Policy(backend="kernel")
    sig = kernelgen.kernel_table("H", "NN")[0]
    g = torch.Generator(device="cuda").manual_seed(37)
    copies = max(1, math.ceil(110e6 / (K * N * 2)))
    x, ws = _main_operands(torch, g, M, K, N, tied, copies=copies)
    n = len(ws)
    reps = max(20, 2 * n)
    _reset_counts()
    got = api.matmul(x, ws[0], policy=kern)
    launches = _counts()
    ab, rel = _rel_err(got, iaat_gemm.gemm_region_plain(sig, x, ws[0]))
    if not rel <= TOL["H"] or launches["iaat_gemm"] < 1 or \
            launches["iaat_scalar"]:
        raise AssertionError(f"IAAT {what}: rel err {rel}, launches "
                             f"{launches}")
    t = {"ms": _time_ms(torch, lambda i: api.matmul(x, ws[i % n],
                                                    policy=kern), reps),
         "plain_ms": _time_ms(torch, lambda i: iaat_gemm.gemm_region_plain(
             sig, x, ws[i % n]), reps),
         "library_ms": _time_ms(torch, lambda i: torch.matmul(x, ws[i % n]),
                                reps),
         "device_ms": _device_ms(torch, lambda i: api.matmul(
             x, ws[i % n], policy=kern), reps, "iaat_gemm_kernel")[0],
         "library_device_ms": _device_ms(torch, lambda i: torch.matmul(
             x, ws[i % n]), reps)[0]}
    bound = cost.gemm_roofline(M, N, K, "H")
    row = {"kernel": "iaat_gemm", "at": what, "M": M, "K": K, "N": N,
           "tied": tied, **t, "bound_ms": bound.seconds * 1e3,
           "bound_by": bound.bound, "launches_a_call":
           launches["iaat_gemm"], "split_launches": launches["iaat_split"],
           "rel_err": rel}
    log(f"kernel time iaat_gemm {what}: H M={M} K={K} N={N} tied={tied}: "
        f"kernel {t['ms']:.4f} ms (device {t['device_ms']} ms; "
        f"{launches['iaat_gemm']} launches a call, {launches['iaat_split']} "
        f"split), plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f}"
        f" ms (device {t['library_device_ms']} ms), bound "
        f"{row['bound_ms']:.4f} ms ({bound.bound})")
    return row


def phase_kernels(torch, cfg, launches, max_abs_err):
    """Kernel / plain / library times and the bound at every main-path
    shape, each weight cycled through enough copies (> 2 x the 50 MB L2)
    that every call reads it from HBM as the decode step does.  The line's
    numbers are one olmo-1b decode step's routed GEMMs at M=4 (the 7
    projections x 16 layers, plus the tied unembed), summed."""
    from repro_torch.core import cost
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = [_iaat_row(torch, M, K, N, tied, f"{cfg.name} M={M}")
            for M in (4, 32) for (K, N, tied) in MAIN_SHAPES]
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
    dev = _decode_step_device(torch, cfg, g)
    log(f"kernel time H one olmo-1b decode step (M=4, {dev['calls']} "
        f"api.matmul calls, distinct weights): summed per-shape loops "
        f"{step['ms']:.4f} ms; one step's loop {dev['loop_ms']:.4f} ms; "
        f"device time (torch.profiler, the step's kernels) "
        f"{dev['device_ms']} ms ({dev['kernels']} kernels); CUDA-graph "
        f"replay {dev['graph_ms']} ms; bound {bound_s * 1e3:.4f} ms; plain "
        f"{step['plain_ms']:.4f} ms, library {step['library_ms']:.4f} ms")
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
        "device_ms": dev["device_ms"],
        "step_loop_ms": dev["loop_ms"],
        "graph_ms": dev["graph_ms"],
        "at": "one olmo-1b decode step's routed GEMMs, M=4, bf16, summed; "
              "device_ms: the profiler's device time of one such step",
    }
    return entry, rows


def _decode_step_device(torch, cfg, g):
    """One olmo-1b decode step's routed GEMMs at M = 4 (per layer q, k, v,
    o, gate, up, down, then the tied unembed), each on its own weight,
    2.3 GB in all, so every weight comes from HBM as in serving.  Returns
    the loop time of the step (CUDA events around the api.matmul calls,
    host launch time included), the device time of its kernels from a
    torch.profiler trace of one step (None if the trace holds no device
    time), and the replay time of the step captured as a CUDA graph (None
    if capture fails; the failure is logged)."""
    from repro_torch import api
    kern = api.Policy(backend="kernel")
    d, f, bf = cfg.d_model, cfg.d_ff, torch.bfloat16

    def weight(k, n):
        return (torch.randn((k, n), generator=g, device="cuda") /
                math.sqrt(k)).to(bf)
    x = torch.randn((4, d), generator=g, device="cuda").to(bf)
    xf = torch.randn((4, f), generator=g, device="cuda").to(bf)
    calls = []
    for _ in range(cfg.n_layers):
        calls += [(x, weight(d, d)) for _ in range(4)]
        calls += [(x, weight(d, f)) for _ in range(2)]
        calls.append((xf, weight(f, d)))
    calls.append((x, weight(cfg.vocab_padded, d).T))

    def step():
        for xi, w in calls:
            api.matmul(xi, w, policy=kern)
    loop_ms = _time_ms(torch, lambda i: step(), 5, warm=2)
    dev_ms, kernels = _device_ms(torch, lambda i: step(), 1,
                                 "iaat_gemm_kernel")
    graph_ms = None
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        graph_ms = _time_ms(torch, lambda i: graph.replay(), 10, warm=2)
    except Exception as e:     # a measurement, not a check: say why
        log(f"kernel time: CUDA-graph capture of the decode step failed: "
            f"{type(e).__name__}: {e}")
    return {"calls": len(calls), "loop_ms": loop_ms, "device_ms": dev_ms,
            "kernels": kernels, "graph_ms": graph_ms}


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
    """The batched and ragged kernels against their plain versions, for
    S/H/D, each launch's path and split asserted from the per-path counts
    against what ``grouped_gemm.launch_plan`` reads from the strides and
    the grid: G in {1, 3, 64} x C in {1, 8, 9, 16, 30} x K in {70, 1408}
    (K 70 is off the ring for S and H), ragged row tiles of 8, 16 and 128
    with empty groups, every table instance on both paths (K tails, N
    overhangs, a split at bk 32), unaligned and strided views; the ring,
    scalar, split and mma paths must each have launched.  Then moonshot's
    decode shapes, which must take mma on the ring, and one token's
    ragged layout, which must also split K.  Returns the max abs errors at the MoE decode shapes
    and the ragged kernel's launches here (no model calls it)."""
    from repro_torch.core import kernelgen
    from repro_torch.kernels import grouped_gemm as gg
    _reset_counts()
    g = torch.Generator(device="cuda").manual_seed(4)
    dts = {"S": torch.float32, "D": torch.float64, "H": torch.bfloat16}
    paths = ("ring", "scalar", "split", "mma")
    worst, seen = {}, {}

    def run(name, letter, x, w, blocks, what, ids=None, tile=None):
        """One launch against its plain version; returns (abs err, path,
        slices)."""
        path, slices = gg.launch_plan(x, w, blocks, tile)
        before = [gg.path_count(p) for p in paths]
        if ids is None:
            got, want = gg.batched_gemm(x, w, blocks=blocks), \
                gg.batched_gemm_plain(x, w)
        else:
            got, want = gg.ragged_gemm(x, w, ids, bm=tile, blocks=blocks), \
                gg.ragged_gemm_plain(x, w, ids, tile)
        torch.cuda.synchronize()
        ran = {p: gg.path_count(p) - b for p, b in zip(paths, before)}
        expect = {"ring": int(path == "ring"), "scalar": int(path == "scalar"),
                  "split": int(slices > 1),
                  "mma": int(path == "ring" and letter == "H")}
        if ran != expect:
            raise AssertionError(f"{name} {letter} {what}: launched {ran}, "
                                 f"want {expect} ({path}, {slices} slices)")
        ab, rel = _rel_err(got, want)
        key = f"{name} {letter} {path}"
        worst[key] = max(worst.get(key, 0.0), rel)
        seen[key] = seen.get(key, 0) + 1
        if not rel <= TOL[letter]:
            raise AssertionError(f"{name} {letter} {what} ({path}, {slices} "
                                 f"slices): rel err {rel} > {TOL[letter]}")
        return ab, path, slices

    def batched_operands(G, C, K, N, dt):
        x = torch.randn((G, C, K), generator=g, device="cuda").to(dt)
        w = torch.randn((G, K, N), generator=g, device="cuda")
        return x, (w / math.sqrt(K)).to(dt)

    for letter, dt in dts.items():
        for G, C, K in itertools.product((1, 3, 64), (1, 8, 9, 16, 30),
                                         (70, 1408)):
            x, w = batched_operands(G, C, K, 1408, dt)
            run("batched", letter, x, w, gg.pick_blocks(C, K, 1408, dt),
                f"G={G} C={C} K={K} N=1408")
        for bm, K in itertools.product((8, 16, 128), (70, 1408)):
            # groups 0 and 3 empty (one zero tile), 6 and 7 with no tile
            x, w, ids = _ragged_operands(torch, g, [0, 5, 17, 0, 40, 3], bm,
                                         K, 1408, dt, empty_tile=True, G=8)
            run("ragged", letter, x, w, gg.pick_blocks(bm, K, 1408, dt),
                f"tile {bm} K={K} N=1408", ids, bm)
        for (lt, bm, bn, bk) in kernelgen.instances():
            if lt != letter:
                continue
            # K 70 (scalar for S and H) and K 136 (a tail on the ring,
            # split at bk 32), N 320 (an overhang of every bn)
            for K in (70, 136):
                x, w = batched_operands(3, 30, K, 320, dt)
                run("batched", letter, x, w, (bm, bn, bk),
                    f"instance {bm}x{bn}x{bk} K={K}")
                x, w, ids = _ragged_operands(torch, g, [0, 5, 17], 8, K, 320,
                                             dt, empty_tile=True)
                run("ragged", letter, x, w, (bm, bn, bk),
                    f"instance {bm}x{bn}x{bk} K={K}", ids, 8)
        # unaligned and strided views: every other column of x and of w,
        # and x one element off its aligned start
        x, w = batched_operands(3, 9, 2 * 1408, 2 * 1408, dt)
        run("batched", letter, x[:, :, ::2], w[::1, ::2, 1::2],
            gg.pick_blocks(9, 1408, 1408, dt), "strided views")
        x, w = batched_operands(3, 9, 1409, 1408, dt)
        run("batched", letter, x[:, :, 1:], w[:, 1:],
            gg.pick_blocks(9, 1408, 1408, dt), "x one element off")
        xr, wr, ids = _ragged_operands(torch, g, [3, 0, 9], 8, 2 * 1408,
                                       1408, dt, empty_tile=True)
        run("ragged", letter, xr[:, ::2], wr[:, ::2],
            gg.pick_blocks(8, 1408, 1408, dt), "strided x rows", ids, 8)
    missing = [p for p in paths if not gg.path_count(p)]
    if missing:
        raise AssertionError(f"grouped check: no launch on {missing}")
    main = {"batched_gemm": 0.0, "ragged_gemm": 0.0}
    E = mcfg.moe.num_experts
    C = _decode_capacity(mcfg)
    counts = _decode_counts(torch, mcfg)
    one = _decode_counts(torch, mcfg, tokens=1)
    for (K, N) in _grouped_decode_shapes(mcfg):
        bf = torch.bfloat16
        x, w = batched_operands(E, C, K, N, bf)
        ab, path, slices = run("batched", "H", x, w,
                               gg.pick_blocks(C, K, N, bf),
                               f"decode {E}x{C}x{K}x{N}")
        main["batched_gemm"] = max(main["batched_gemm"], ab)
        xr, wr, ids = _ragged_operands(torch, g, counts, 8, K, N, bf,
                                       empty_tile=False)
        ab, rpath, rslices = run("ragged", "H", xr, wr,
                                 gg.pick_blocks(8, K, N, bf),
                                 f"decode T={xr.shape[0]} K={K} N={N}", ids,
                                 8)
        main["ragged_gemm"] = max(main["ragged_gemm"], ab)
        # one token's dropless layout: 6 tiles, a grid that splits
        x1, w1, ids1 = _ragged_operands(torch, g, one, 8, K, N, bf,
                                        empty_tile=False)
        _, path1, slices1 = run("ragged", "H", x1, w1,
                                gg.pick_blocks(8, K, N, bf),
                                f"decode 1 token K={K} N={N}", ids1, 8)
        if path != "ring" or rpath != "ring" or path1 != "ring" or \
                slices1 < 2:
            raise AssertionError(f"decode K={K} N={N}: batched {path}, "
                                 f"ragged {rpath}, one token {path1} x "
                                 f"{slices1} slices")
        log(f"check grouped decode K={K} N={N}: batched ({E}, {C}) on the "
            f"mma ring, {slices} slice(s), max abs err "
            f"{main['batched_gemm']:.4g}; ragged {xr.shape[0]} rows in "
            f"{ids.numel()} tiles of 8 on the mma ring, {rslices} "
            f"slice(s), max abs err {main['ragged_gemm']:.4g}; one token's "
            f"{ids1.numel()} tiles on the mma ring in {slices1} slices")
    launches = _counts()
    log("check grouped: worst rel err by kernel, letter and path (tol S "
        "1e-5, H 8e-3, D 1e-12): "
        + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()})
        + f"; cases {json.dumps(seen)}; launches {json.dumps(launches)}")
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


def _split_sweep(torch, g, w, K, N, blocks, reps=20):
    """Device time (us) of the ragged kernel on row tiles of 8 over w
    (G, K, N), at 1..20 tiles (one token's layout is 6, four tokens' 20)
    and 1, 2, 4 and 8 K slices whatever the rule says: what the grouped
    split rule (plan.grouped_slices) is read from.  Logged as a table;
    returns {tiles: {"rule": slices, slices: us}}."""
    from repro_torch.kernels import grouped_gemm as gg
    out = {}
    for tiles in (1, 4, 6, 8, 11, 16, 20):
        x = torch.randn((8 * tiles, K), generator=g, device="cuda").to(
            w.dtype)
        ids = (torch.arange(tiles, device="cuda", dtype=torch.int32) * 3) \
            % w.shape[0]
        res = {"rule": gg.launch_plan(x, w, blocks, tile=8)[1]}
        for sl in (1, 2, 4, 8):
            ms, _ = _device_ms(torch, lambda i: gg._launch_ragged(
                x, w, ids, 8, blocks, slices=sl), reps, "grouped_gemm_kernel")
            res[sl] = None if ms is None else round(ms * 1e3, 2)
        out[tiles] = res
    gn = -(-N // blocks[1])
    log(f"split sweep ragged_gemm H K={K} N={N} {blocks}: device us at "
        f"1/2/4/8 slices [rule] by tiles of 8 (x {gn} blocks): "
        + "; ".join(f"{t}: {r[1]}/{r[2]}/{r[4]}/{r[8]} [{r['rule']}]"
                    for t, r in out.items()))
    return out


def phase_grouped_kernels(torch, mcfg, launches, errs):
    """Kernel / plain / library times and the bound of the grouped kernels
    at the MoE decode shapes (one batched call reads all experts' weights,
    >= 369 MB, over 7 x the 50 MB L2, so every call reads from HBM): loop
    time (CUDA events, host launch time included) and device time
    (torch.profiler, the calls' device kernels).  The line's numbers are
    one decode step's expert GEMMs (layers x gate, up, down), summed: as
    equal-capacity groups for batched_gemm, as the dropless ragged layout
    of the same 4 tokens for ragged_gemm.  The library calls are torch.bmm
    and torch._grouped_mm; the latter's output is first held against the
    plain version.  The ragged call is also timed at one and two K slices
    whatever the split rule says (what decides the rule for the down
    projection's 160 blocks)."""
    from repro_torch.core import cost
    from repro_torch.kernels import grouped_gemm as gg
    g = torch.Generator(device="cuda").manual_seed(6)
    bf = torch.bfloat16
    E, C, L = mcfg.moe.num_experts, _decode_capacity(mcfg), mcfg.n_layers
    counts = _decode_counts(torch, mcfg)
    rows = []
    keys = ("ms", "plain_ms", "library_ms", "device_ms", "plain_device_ms",
            "library_device_ms")
    step = {n: {**{k: 0.0 for k in keys}, "flops": 0, "bytes": 0}
            for n in ("batched_gemm", "ragged_gemm")}
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
        calls = {
            "batched_gemm": (lambda i: gg.batched_gemm(x, w, blocks=blocks),
                             lambda i: gg.batched_gemm_plain(x, w),
                             lambda i: torch.bmm(x, w)),
            "ragged_gemm": (lambda i: gg._launch_ragged(xr, wr, ids, 8,
                                                        rblocks),
                            lambda i: gg.ragged_gemm_plain(xr, wr, ids, 8),
                            None if lib_call is None else
                            (lambda i: lib_call())),
        }
        work = {   # bytes: each input read once (ragged: the groups used)
            "batched_gemm": (2 * E * C * K * N,
                             2 * (E * C * K + E * K * N + E * C * N)),
            "ragged_gemm": (2 * T * K * N,
                            2 * (T * K + groups * K * N + T * N)),
        }
        for name, (f_k, f_p, f_l) in calls.items():
            t = {"ms": _time_ms(torch, f_k, 20),
                 "plain_ms": _time_ms(torch, f_p, 20),
                 "library_ms": None if f_l is None else
                 _time_ms(torch, f_l, 20),
                 "device_ms": _device_ms(torch, f_k, 10,
                                         "grouped_gemm_kernel")[0],
                 "plain_device_ms": _device_ms(torch, f_p, 10)[0],
                 "library_device_ms": None if f_l is None else
                 _device_ms(torch, f_l, 10)[0]}
            flops, nbytes = work[name]
            b_s = max(flops / cost.PEAK_FLOPS_BF16, nbytes / cost.HBM_BW)
            row = {"kernel": name, "K": K, "N": N, **t,
                   "bound_ms": b_s * 1e3, "flops": flops, "bytes": nbytes}
            if name == "ragged_gemm":
                row.update(rows=T, groups=groups, slices=gg.launch_plan(
                    xr, wr, rblocks, tile=8)[1],
                    split_sweep=_split_sweep(torch, g, w, K, N, rblocks))
            else:
                row["slices"] = gg.launch_plan(x, w, blocks)[1]
            rows.append(row)
            log(f"kernel time {name} H K={K} N={N}"
                + (f" ({T} rows, {groups} groups)" if name == "ragged_gemm"
                   else f" ({E} x {C} rows)")
                + f": kernel {t['ms']:.4f} ms (device {t['device_ms']} ms), "
                + f"plain {t['plain_ms']:.4f} ms (device "
                + f"{t['plain_device_ms']} ms), "
                + ("library torch._grouped_mm" if name == "ragged_gemm"
                   else "library torch.bmm")
                + (" refused" if t["library_ms"] is None else
                   f" {t['library_ms']:.4f} ms (device "
                   f"{t['library_device_ms']} ms)")
                + f", bound {b_s * 1e3:.4f} ms")
            n = per_layer * L
            st = step[name]
            for k in keys:
                st[k] = None if t[k] is None or st[k] is None else \
                    st[k] + n * t[k]
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
            "device_ms": st["device_ms"],
            "plain_device_ms": st["plain_device_ms"],
            "library_device_ms": st["library_device_ms"],
            "at": f"one {mcfg.name} decode step's expert GEMMs ({L} layers "
                  "x gate, up, down), bf16, summed; ms the loop time, "
                  "device_ms the profiler's"
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
        # head dims between the instances, zero-padded to the next one
        # (20 -> 32, 112 -> 128) and held against the plain version at
        # the head dim as it is
        for D, window in itertools.product((20, 112), (None, 24)):
            run(name, 3, 8, 2, 80, 80, D, causal=True, window=window)
            cases += 1
        for Hq, Hkv in ((16, 16), (8, 2)):     # a decode-like query
            run(name, 3, Hq, Hkv, 1, 64, 128, causal=True, q_offset=63)
        # non-causal with Sq != Sk: cross attention (decode's one query,
        # a prompt) and the encoder, 1000 keys ending on a partial tile
        for (Sq, Sk), (Hq, Hkv), D in itertools.product(
                ((1, 1000), (4, 1000), (33, 1000), (1000, 1000)),
                ((16, 16), (8, 2)), (64, 20)):
            run(name, 4, Hq, Hkv, Sq, Sk, D, causal=False)
            cases += 1
        run(name, 2, 16, 16, 80, 80, 128, view=True, window=24)
        out = run(name, 1, 4, 1, 1, 64, 128, q_offset=200, window=24)
        if out.any():
            raise AssertionError("flash: a query with no valid key gave a "
                                 "non-zero row")
        cases += 8
    n = _counts()
    launches = n["flash_attention"]
    log(f"check flash: {cases} cases, {launches} launches ({n['flash_tc']} "
        f"tensor-core, {n['flash_cuda_core']} CUDA-core); worst max abs "
        f"err (f32 allclose {FLASH_TOL_F32}, bf16 one step): "
        + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()}))
    if launches != cases or not n["flash_tc"] or not n["flash_cuda_core"]:
        raise AssertionError(f"flash check: launches {n} for {cases} cases")
    return {"cases": cases, "launches": launches,
            "launches_tc": n["flash_tc"],
            "launches_cuda_core": n["flash_cuda_core"],
            "worst_max_abs": worst}


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


def phase_wave_serve(torch, cfg, params, requests=6, max_new=16,
                     long_prompt=2048):
    """``cfg`` (olmo-1b, gemma3-1b) through the wave ContinuousBatcher (4
    slots) on the paged phase's requests, under ``auto`` and the forced
    kernel, after an uncounted warm-up; then one ``long_prompt``-token
    prompt under ``auto``.  Every prefill wave must launch the flash
    kernel once per layer and no decode step may launch it."""
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
        if launches["flash_tc"] != launches["flash_attention"]:
            raise AssertionError(f"wave {backend}: bf16 D "
                                 f"{cfg.head_dim_} attention off the "
                                 f"tensor-core kernel: {launches}")
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
    prompt = np.random.RandomState(2).randint(0, cfg.vocab, long_prompt)
    runs["long"], done = counted("auto", [Request(0, prompt, max_new=4)],
                                 max_len=long_prompt + 4)
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
    128, bf16, causal (:func:`_flash_row`)."""
    # the wave's prefill, S 2048 at olmo's 16 x 128, and S 2048 at head
    # dim 256 with the same width (8 heads)
    rows = [_flash_row(torch, B, H, H, S, D, None, f"{cfg.name} B{B} S{S}")
            for B, S, H, D in ((*serve_shape, cfg.n_heads, cfg.head_dim_),
                               (1, 2048, cfg.n_heads, cfg.head_dim_),
                               (1, 2048, cfg.d_model // 256, 256))]
    main, long, wide = rows
    H, D = main["Hq"], main["D"]
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
        "device_ms": main["device_ms"],
        "library_device_ms": main["library_device_ms"],
        "at_2048": {k: long[k] for k in ("ms", "device_ms", "plain_ms",
                                         "library_ms", "library_device_ms",
                                         "bound_ms", "bound_by",
                                         "max_abs_err")},
        "at_2048_d256": {k: wide[k] for k in ("Hq", "ms", "device_ms",
                                              "plain_ms", "library_ms",
                                              "library_device_ms",
                                              "bound_ms", "bound_by",
                                              "max_abs_err")},
    }
    return entry, rows


# --------------------------------------------------------------------------
# The SSM family: mamba2-780m served and scored, the SSD scan kernel.
# --------------------------------------------------------------------------

#: SSD kernel vs plain in f32: the reference's tolerance for its SSD sweep
#: (``tests/test_kernels_other.py:114-150``), as allclose
SSD_RTOL, SSD_ATOL = 1e-4, 1e-5


def _ssd_operands(torch, g, Bt, S, H, P, N, dtype):
    """x, dt, A, B, C as the model passes them: x, B and C strided views
    cut from one (Bt, S, H P + 2 N) conv row, dt and A in f32; values of
    the reference tests' scale (``_ssd_inputs``)."""
    row = (torch.randn((Bt, S, H * P + 2 * N), generator=g, device="cuda")
           * 0.3).to(dtype)
    x = row[..., :H * P].reshape(Bt, S, H, P)
    B = row[..., H * P:H * P + N].reshape(Bt, S, 1, N)
    C = row[..., H * P + N:].reshape(Bt, S, 1, N)
    dt = torch.randn((Bt, S, H), generator=g, device="cuda").abs() * 0.1 \
        + 0.01
    A = -torch.randn((H,), generator=g, device="cuda").abs() * 0.5 - 0.1
    return x, dt, A, B, C


def _ssd_err(torch, got, want, what):
    """max|got - want|, held to allclose(SSD_RTOL, SSD_ATOL) in f32 and to
    one bf16 step of the largest output in bf16."""
    d = (got.float() - want.float()).abs().max().item()
    if got.dtype == torch.float32:
        ok = torch.allclose(got, want, rtol=SSD_RTOL, atol=SSD_ATOL)
    else:
        ok = d <= BF16_STEP * want.float().abs().max().item()
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"ssd {what}: kernel vs plain max abs err {d}")
    return d


def phase_ssd_check(torch, scfg):
    """The SSD kernel against its plain version on the card."""
    from repro_torch.kernels import ssd
    _reset_counts()
    g = torch.Generator(device="cuda").manual_seed(13)
    s_full = scfg.ssm
    # (N, P): the smoke width, P a multiple of 4 but not of 8 (held
    # padded to 16 on the card), the model's width
    widths = {"smoke": (16, 8), "p12": (20, 12),
              "full": (s_full.d_state, s_full.head_dim)}
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    worst = {}
    cases = want_launches = 0
    for name, Bt, S, chunk, width in itertools.product(
            dts, (1, 3), (1, 17, 100, 128, 300, 2048), ssd.CHUNKS, widths):
        N, P = widths[width]
        a = _ssd_operands(torch, g, Bt, S, 4, P, N, dts[name])
        got = ssd.ssd_scan(*a, chunk=chunk)
        want = ssd.ssd_scan_plain(*a, chunk=chunk)
        torch.cuda.synchronize()
        ab = _ssd_err(torch, got, want, f"{name} Bt{Bt} S{S} chunk{chunk} "
                      f"N{N} P{P}")
        key = f"{name} {width}"
        worst[key] = max(worst.get(key, 0.0), ab)
        cases += 1
        want_launches += ssd.launches_per_scan(S, chunk)
    n = _counts()
    launches, scans = n["ssd_scan"], n["ssd_scans"]
    if scans != cases or launches != want_launches:
        raise AssertionError(f"ssd check: {scans} scans of {launches} "
                             f"launches for {cases} cases of "
                             f"{want_launches} launches")
    log(f"check ssd: {cases} cases (4 heads, strided views), {scans} scans "
        f"of {launches} launches; worst max abs err (f32 allclose rtol "
        f"{SSD_RTOL} atol {SSD_ATOL}, bf16 one step): "
        + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()}))
    return {"cases": cases, "launches": launches, "scans": scans,
            "worst_max_abs": worst}


def phase_ssm_serve(torch, scfg):
    """mamba2-780m through PagedEngine: IAAT launches > 0 (phase_serve's
    check) and no SSD launch in either run."""
    runs, params = phase_serve(torch, SSM_ARCH, scfg, 6, 16, ["iaat_gemm"])
    for backend, r in runs.items():
        if r["launch_counts"]["ssd_scan"]:
            raise AssertionError(f"{SSM_ARCH} {backend}: serving launched "
                                 "the SSD kernel; it runs paged_step")
    return runs, params


def phase_ssm_forward(torch, scfg, params, Bt=2, S=2048):
    """One full-width forward_train over Bt x S tokens under no_grad,
    through the kernels (counted from 0: one SSD scan per layer, each of
    ``ssd.launches_per_scan`` launches), under ``auto`` (timed, counted
    the same) and through the plain arithmetic (ref.ref_ssd,
    torch.matmul), logits compared at STEP_TOL.  In bf16 a rounding flip
    in one layer propagates through the rest, so the same forward is then
    run with the weights widened to f32 (in place: the phase is their last
    user) and held to FWD_F32_TOL."""
    import dataclasses
    from repro_torch import api
    from repro_torch.kernels import ssd
    from repro_torch.models import lm
    g = torch.Generator(device="cuda").manual_seed(17)
    toks = torch.randint(0, scfg.vocab, (Bt, S), generator=g, device="cuda")
    out = {"Bt": Bt, "S": S}
    with torch.no_grad():
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lk, _ = lm.forward_train(params, scfg, api.Policy(backend="kernel"),
                                 toks)
        torch.cuda.synchronize()
        out["kernel_s"] = time.perf_counter() - t0
        counts = _counts()
        _reset_counts()
        t0 = time.perf_counter()
        la, _ = lm.forward_train(params, scfg, api.Policy(backend="auto"),
                                 toks)
        torch.cuda.synchronize()
        out["auto_s"] = time.perf_counter() - t0
        out["auto_launch_counts"] = _counts()
        del la
        t0 = time.perf_counter()
        lp, _ = lm.forward_train(params, scfg, api.Policy(backend="library"),
                                 toks)
        torch.cuda.synchronize()
        out["library_s"] = time.perf_counter() - t0
    # one scan a layer, each of launches_per_scan launches
    per = ssd.launches_per_scan(S, scfg.ssm.chunk)
    for what, n in (("kernel", counts), ("auto", out["auto_launch_counts"])):
        if n["ssd_scans"] != scfg.n_layers or \
                n["ssd_scan"] != scfg.n_layers * per:
            raise AssertionError(
                f"forward_train under {what}: {n['ssd_scans']} SSD scans of "
                f"{n['ssd_scan']} launches, want {scfg.n_layers} of "
                f"{scfg.n_layers * per}")
    if counts["iaat_gemm"] <= 0:
        raise AssertionError("forward_train under kernel: no IAAT launch")
    if tuple(lk.shape) != (Bt, S, scfg.vocab_padded) or not (
            torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError(f"forward_train logits {tuple(lk.shape)}, "
                             "or non-finite")
    ab, rel = _rel_err(lk, lp)
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    out.update({"launches": counts["ssd_scan"], "scans": counts["ssd_scans"],
                "launch_counts": counts, "max_abs_err": ab, "rel_err": rel,
                "argmax_agree": agree})
    log(f"ssm forward {scfg.name} {Bt}x{S}: kernel {out['kernel_s']:.3f} s "
        f"(launches {json.dumps(counts)}), auto {out['auto_s']:.3f} s "
        f"(IAAT {out['auto_launch_counts']['iaat_gemm']}, SSD "
        f"{out['auto_launch_counts']['ssd_scan']} launches), library "
        f"{out['library_s']:.3f} s; logits max abs err {ab:.4g}, rel "
        f"{rel:.3g} (tol {STEP_TOL}), argmax agreement {agree:.4f}")
    if not rel <= STEP_TOL:
        raise AssertionError(f"forward_train rel err {rel} > {STEP_TOL}")
    del lk, lp
    params.embed.data = params.embed.data.float()
    for blk in params.blocks:
        for w in (blk.mixer.in_proj, blk.mixer.out_proj):
            w.data = w.data.float()
    cfg32 = dataclasses.replace(scfg, dtype="float32")
    with torch.no_grad():
        lk, _ = lm.forward_train(params, cfg32, api.Policy(backend="kernel"),
                                 toks)
        lp, _ = lm.forward_train(params, cfg32,
                                 api.Policy(backend="library"), toks)
        torch.cuda.synchronize()
    ab32, rel32 = _rel_err(lk, lp)
    out.update({"f32_max_abs_err": ab32, "f32_rel_err": rel32})
    log(f"ssm forward {scfg.name} {Bt}x{S}, weights widened to f32: logits "
        f"max abs err {ab32:.4g}, rel {rel32:.3g} (tol {FWD_F32_TOL})")
    if not (torch.isfinite(lk).all() and rel32 <= FWD_F32_TOL):
        raise AssertionError(f"f32 forward_train rel err {rel32} > "
                             f"{FWD_F32_TOL}")
    return out


def _ssd_bound(x, B, chunk):
    """(flops, flops with C Bᵀ once a head, bytes) of one SSD scan: per
    chunk of n real tokens the lower triangle of C Bᵀ (2 N a pair), once
    for every head (B and C are shared by the heads), and per head the
    triangle of the scores @ x (2 P a pair), C @ h (2 n N P) for every
    chunk but the first (the scan starts from a zero state) and the state
    update (2 n N P) for every chunk but the last (no final state is
    returned); each of x, dt, A, B, C read once and y written once.  The
    elementwise terms (cumsum, exp, the scalings) are left out: they are
    O(n^2) or O(n N), under 1 % of the dots here."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    cb = per_head = 0
    for c0 in range(0, S, chunk):
        n = min(chunk, S - c0)
        cb += (n * (n + 1) // 2) * 2 * N
        per_head += (n * (n + 1) // 2) * 2 * P
        per_head += 2 * n * N * P * ((c0 > 0) + (c0 + chunk < S))
    isz = x.element_size()
    nbytes = (2 * Bt * S * H * P * isz + 2 * Bt * S * N * isz
              + Bt * S * H * 4 + H * 4)
    return Bt * (cb + H * per_head), Bt * H * (cb + per_head), nbytes


def phase_ssd_kernels(torch, scfg, launches, Bt=2, S=2048):
    """SSD kernel / plain / ref.ref_ssd loop and device times, the
    launches of one scan and the bound at the forward's shape: Bt x S
    tokens, mamba2-780m's 48 heads x P 64, N 128, chunk 128, f32 (the
    conv output the model feeds it is f32).  The bound counts C Bᵀ once a
    (batch, chunk), the least work; the count with C Bᵀ once a head
    (as a kernel that walks each head alone computes it) is given beside
    it.  No single PyTorch call computes the
    scan, so ``library_ms`` is null; the yardstick is the model's own
    library path, ``ref.ref_ssd``, timed beside it."""
    from repro_torch.core import cost
    from repro_torch.kernels import ref, ssd
    s = scfg.ssm
    g = torch.Generator(device="cuda").manual_seed(19)
    a = _ssd_operands(torch, g, Bt, S, scfg.ssm_heads, s.head_dim,
                      s.d_state, torch.float32)
    want = ssd.ssd_scan_plain(*a, chunk=s.chunk)
    _reset_counts()
    ab = _ssd_err(torch, ssd.ssd_scan(*a, chunk=s.chunk), want,
                  f"timing shape Bt{Bt} S{S}")
    per_scan = ssd.launch_count()
    t_k = _time_ms(torch, lambda i: ssd.ssd_scan(*a, chunk=s.chunk), 20)
    t_p = _time_ms(torch, lambda i: ssd.ssd_scan_plain(*a, chunk=s.chunk),
                   5)
    t_r = _time_ms(torch, lambda i: ref.ref_ssd(*a, chunk=s.chunk), 5, 1)
    d_k, n_k = _device_ms(torch, lambda i: ssd.ssd_scan(*a, chunk=s.chunk),
                          10, "ssd_", per_call=per_scan)
    d_r, _ = _device_ms(torch, lambda i: ref.ref_ssd(*a, chunk=s.chunk), 3)
    # the three launches of a scan, each alone
    parts = {k: _device_ms(torch, lambda i: ssd.ssd_scan(*a, chunk=s.chunk),
                           10, k, per_call=1)[0]
             for k in ("ssd_state_kernel", "ssd_pass_kernel",
                       "ssd_out_kernel")}
    flops, flops_head, nbytes = _ssd_bound(a[0], a[3], s.chunk)
    t_bytes = nbytes / cost.HBM_BW
    t_ops, t_ops_head = flops / cost.PEAK_FLOPS_F32, \
        flops_head / cost.PEAK_FLOPS_F32
    bound = max(t_ops, t_bytes) * 1e3
    bound_head = max(t_ops_head, t_bytes) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    _, hg1, hg3 = ssd.launch_plan(Bt, S, scfg.ssm_heads, s.d_state,
                                  s.head_dim, s.chunk)
    log(f"kernel time ssd_scan f32 Bt={Bt} S={S} H={scfg.ssm_heads} "
        f"P={s.head_dim} N={s.d_state} chunk={s.chunk}: kernel {t_k:.4f} ms "
        f"loop, {d_k} ms device ({per_scan} launches a scan, {n_k} device "
        f"kernels over 10 scans; heads a block {hg1} and {hg3}), plain "
        f"{t_p:.4f} ms, ref_ssd {t_r:.4f} ms loop, {d_r} ms device; bound "
        f"{bound:.4f} ms ({by}: {flops / 1e9:.3f} GFLOP with C Bᵀ once a "
        f"batch and chunk, {nbytes / 1e6:.2f} MB; "
        f"{flops / (t_k * 1e-3) / 1e12:.2f} TFLOP/s), {bound_head:.4f} ms "
        f"with C Bᵀ once a head ({flops_head / 1e9:.3f} GFLOP); device ms "
        f"by kernel {json.dumps(parts)}; kernel vs plain max abs err "
        f"{ab:.4g}")
    if per_scan != ssd.launches_per_scan(S, s.chunk) or \
            n_k != 10 * per_scan:
        raise AssertionError(f"ssd timing shape: {per_scan} launches a "
                             f"scan, {n_k} device kernels over 10 scans")
    row = {"Bt": Bt, "S": S, "H": scfg.ssm_heads, "P": s.head_dim,
           "N": s.d_state, "chunk": s.chunk, "ms": t_k, "device_ms": d_k,
           "plain_ms": t_p, "ref_ssd_ms": t_r, "ref_ssd_device_ms": d_r,
           "bound_ms": bound, "bound_by": by,
           "bound_ms_cb_per_head": bound_head, "flops": flops,
           "flops_cb_per_head": flops_head, "bytes": nbytes,
           "launches_per_scan": per_scan, "heads_per_block": [hg1, hg3],
           "device_ms_by_kernel": parts, "max_abs_err": ab}
    entry = {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd.py:25",
        "launches": launches,
        "max_abs_err": ab,
        "ms": t_k,
        "plain_ms": t_p,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
        "device_ms": d_k,
        "ref_ssd_ms": t_r,
        "bound_ms_cb_per_head": bound_head,
        "at": f"one {scfg.name} forward_train layer's scan, Bt {Bt} x S {S} "
              f"x {scfg.ssm_heads} heads x P {s.head_dim}, N {s.d_state}, "
              f"chunk {s.chunk}, f32; launches per forward_train "
              f"({per_scan} a scan)",
    }
    return entry, [row]


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


def _run_grid(torch, policy, check_route=None, one_launch=False):
    """``api.gemm`` under ``policy`` over every grid case, each output
    finite and within GRID_TOL of the plain version.  ``check_route(d,
    letter, trans, M, N, K)`` sees each case's Decision first; with
    ``one_launch`` every C/Z call must launch the complex kernel exactly
    once.  Returns (cases, worst rel err per letter and trans, max abs err
    per letter)."""
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
        n0 = iaat_gemm.launch_count("cx_gemm")
        out = api.gemm(a, b, c, alpha, beta, ta, tb, policy=policy)
        n = iaat_gemm.launch_count("cx_gemm") - n0
        if one_launch and letter in ("C", "Z") and n != 1:
            raise AssertionError(f"grid {letter} {tr} {what}: {n} complex "
                                 "kernel launches, want one a call")
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
    0; both the real and the complex kernel must have launched, every
    complex call exactly once (one launch a plan, whatever its
    regions)."""
    from repro_torch import api
    from repro_torch.configs import paper_gemm
    from repro_torch.core import plan as plan_mod
    _reset_counts()
    cases, worst, max_abs = _run_grid(torch, api.Policy(backend="kernel"),
                                      one_launch=True)
    launches = _counts()
    cfg = paper_gemm.CONFIG
    regions = sum(
        plan_mod.build_plan(M, N, K, letter, trans).num_kernel_calls
        for letter in ("C", "Z") for trans in cfg.transpositions
        for (M, N, K) in [(n, n, n) for n in cfg.sizes(trans)]
        + list(GRID_RAGGED))
    log(f"grid check (forced kernel): {cases} GEMMs, launches "
        f"{json.dumps({k: launches[k] for k in ('iaat_gemm', 'cx_gemm')})}"
        f", every complex call one launch (their cube and ragged plans "
        f"hold {regions} regions); worst rel err (tol S 2e-5, D 1e-12, C "
        "2e-4, Z 1e-12): "
        + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()}))
    for k in ("iaat_gemm", "cx_gemm"):
        if launches[k] <= 0:
            raise AssertionError(f"grid check: {k} never ran")
    return {"cases": cases, "launches": launches, "worst_rel": worst,
            "max_abs_err": max_abs, "complex_regions": regions}


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
    # the load path each class was timed on: the cp.async ring wherever
    # op(A) is read along K (NN, NT; every shape on the 16-byte grain),
    # the scalar path where it is not (TN, TT), the one complex path
    paths = {}
    for key, e in prof.entries.items():
        sc = classes.SizeClass.from_key(key.split(":")[-1])
        want = "complex" if sc.letter in ("C", "Z") else \
            "ring" if sc.trans[0] == "N" else "scalar"
        if e.path != want:
            raise AssertionError(f"tune {key}: timed on {e.path}, want "
                                 f"{want}")
        paths[e.path] = paths.get(e.path, 0) + 1
    log(f"tune: classes by the load path timed {json.dumps(paths)}")
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
            "timed_paths": paths,
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
    plan, one launch), as a loop (CUDA events, host time included) and as
    device time (torch.profiler, the kernel alone); the library call is
    ``torch.matmul`` on the complex tensors (TF32 off), timed here only,
    both ways.  The bound counts the Karatsuba's 6MNK + 5MN operations at
    the plane type's peak (``cost.gemm_roofline``).  The line's numbers
    are C at 80^3."""
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
            n0 = iaat_gemm.launch_count("cx_gemm")
            api.gemm(a, b, policy=kern)
            per_call = iaat_gemm.launch_count("cx_gemm") - n0
            t_k = _time_ms(torch, lambda i: api.gemm(a, b, policy=kern),
                           reps)
            t_p = _time_ms(torch, lambda i: iaat_gemm.gemm_region_plain(
                sig, a, b), reps)
            t_l = _time_ms(torch, lambda i: torch.matmul(a, b), reps)
            d_k, _ = _device_ms(torch, lambda i: api.gemm(a, b, policy=kern),
                                reps, "cx_gemm", per_call=1)
            d_l, _ = _device_ms(torch, lambda i: torch.matmul(a, b), reps)
            bound = cost.gemm_roofline(n, n, n, letter)
            p = plan_mod.build_plan(n, n, n, letter, "NN")
            row = {"letter": letter, "n": n, "ms": t_k, "device_ms": d_k,
                   "plain_ms": t_p, "library_ms": t_l,
                   "library_device_ms": d_l, "bound_ms": bound.seconds * 1e3,
                   "bound_by": bound.bound, "flops": bound.flops,
                   "bytes": bound.hbm_bytes, "launches_per_call": per_call,
                   "regions": p.num_kernel_calls,
                   "blocks": [r.sig.name for r in p.regions],
                   "max_abs_err": ab, "library_rel_err": lib_rel}
            rows.append(row)
            log(f"kernel time cx_gemm {letter} {n}^3: kernel {t_k:.4f} ms "
                f"loop, {d_k} ms device ({per_call} launch over "
                f"{p.num_kernel_calls} regions: {row['blocks']}), plain "
                f"{t_p:.4f} ms, library (torch.matmul) {t_l:.4f} ms loop, "
                f"{d_l} ms device (rel err vs plain {lib_rel:.3g}), bound "
                f"{row['bound_ms']:.5f} ms ({bound.bound}: "
                f"{bound.flops / 1e9:.4f} GFLOP, {bound.hbm_bytes / 1e6:.3f} "
                f"MB), {bound.flops / t_k / 1e9:.2f} TFLOP/s; kernel vs "
                f"plain rel err {rel:.3g}")
            if per_call != 1:
                raise AssertionError(f"complex kernel {letter} {n}^3: "
                                     f"{per_call} launches a call")
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
        "device_ms": main["device_ms"],
        "more": {f"{r['letter']}{r['n']}": {
            k: r[k] for k in ("ms", "device_ms", "plain_ms", "library_ms",
                              "library_device_ms", "bound_ms", "bound_by",
                              "launches_per_call")}
            for r in rows},
    }
    return entry, rows


# --------------------------------------------------------------------------
# The online tuner, the per-stream split tickets and the trace.
# --------------------------------------------------------------------------

ONLINE_REQUESTS, ONLINE_MAX_NEW = 12, 32


def phase_concurrent_split(torch, mcfg, reps=6):
    """olmo-1b's four decode shapes (M = 4, K split on the ring) and one
    moonshot ``batched_gemm`` decode call on two streams at once, ``reps``
    times over: both streams first queue a spin kernel, so their launches
    pile up and run side by side.  Every output matches its plain version
    at the check's tolerances, and the split launches are counted on each
    stream (the IAAT kernel keeps its tickets per stream)."""
    from repro_torch import api
    from repro_torch.kernels import grouped_gemm, iaat_gemm
    kern = api.Policy(backend="kernel")
    g = torch.Generator(device="cuda").manual_seed(20)
    ops = [_main_operands(torch, g, 4, K, N, tied)
           for K, N, tied in MAIN_SHAPES]
    want = [iaat_gemm.gemm_region_plain(
        _plan_of(4, N, K).regions[0].sig, x, ws[0])
        for (x, ws), (K, N, _) in zip(ops, MAIN_SHAPES)]
    # q/k/v/o, gate/up and down split K; the tied vocabulary head's grid
    # fills the card, so it runs unsplit beside them
    plans = [_plan_of(4, N, K).regions for K, N, _ in MAIN_SHAPES]
    split_per_pass = sum(r.slices > 1 for regions in plans
                         for r in regions)
    if [any(r.slices > 1 for r in regions) for regions in plans] != \
            [not tied for _K, _N, tied in MAIN_SHAPES]:
        raise AssertionError("concurrent split: the decode shapes' K "
                             f"slices are not the main path's: {plans}")
    E, C = mcfg.moe.num_experts, _decode_capacity(mcfg)
    Kg, Ng = next(iter(_grouped_decode_shapes(mcfg)))        # gate/up
    gx = torch.randn((E, C, Kg), generator=g, device="cuda").to(
        torch.bfloat16)
    gw = (torch.randn((E, Kg, Ng), generator=g, device="cuda") /
          math.sqrt(Kg)).to(torch.bfloat16)
    gwant = grouped_gemm.batched_gemm_plain(gx, gw)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    _reset_counts()
    outs, split, batched = [[], []], [0, 0], [0, 0]
    for _ in range(reps):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                torch.cuda._sleep(2_000_000)     # ~1 ms: let both queue
        for i, s in enumerate(streams):
            n0, b0 = iaat_gemm.path_count("split"), \
                grouped_gemm.launch_count("batched_gemm")
            with torch.cuda.stream(s):
                outs[i].append([api.matmul(x, ws[0], policy=kern)
                                for x, ws in ops] +
                               [grouped_gemm.batched_gemm(gx, gw)])
            split[i] += iaat_gemm.path_count("split") - n0
            batched[i] += grouped_gemm.launch_count("batched_gemm") - b0
    torch.cuda.synchronize()
    worst = 0.0
    for i in range(2):
        for res in outs[i]:
            for got, w in zip(res, want + [gwant]):
                _, rel = _rel_err(got, w)
                worst = max(worst, rel)
                if not rel <= TOL["H"]:
                    raise AssertionError(f"concurrent split: stream {i} rel "
                                         f"err {rel} > {TOL['H']}")
    if split != [reps * split_per_pass] * 2 or batched != [reps] * 2:
        raise AssertionError(f"concurrent split: split launches {split}, "
                             f"batched {batched} per stream, want "
                             f"{reps * split_per_pass} and {reps}")
    keys = [k for k in iaat_gemm._tickets if k[1] in
            (streams[0].cuda_stream, streams[1].cuda_stream)]
    if len(keys) != 2:
        raise AssertionError(f"concurrent split: ticket arrays {keys}")
    log(f"concurrent split: {reps} passes on each of 2 streams, split "
        f"launches per stream {split}, batched {batched}, one ticket array "
        f"a stream; worst rel err {worst:.3g} (tolerance {TOL['H']})")
    return {"split_per_stream": split, "batched_per_stream": batched,
            "worst_rel_err": worst}


@contextlib.contextmanager
def _empty_tune_cache():
    """A fresh, empty tune cache for the body; the active profile is
    cleared on the way in and out, and the environment restored."""
    import os
    from repro_torch.tune import profile as profile_mod
    env = os.environ.get(profile_mod.CACHE_ENV)
    with tempfile.TemporaryDirectory() as cache:
        os.environ[profile_mod.CACHE_ENV] = cache
        profile_mod.clear_active_profile()
        try:
            yield cache
        finally:
            profile_mod.clear_active_profile()
            if env is None:
                os.environ.pop(profile_mod.CACHE_ENV, None)
            else:
                os.environ[profile_mod.CACHE_ENV] = env


def _smoke_swap_parity(torch):
    """olmo-smoke in f32 on the card under ``tuned``: a run with manual
    ``set_active_profile`` swaps between steps (p1: every routed class on
    the kernel, p2: on the library) gives the tokens of a run with none."""
    import dataclasses
    import numpy as np
    from repro_torch import api, configs, obs
    from repro_torch.core import kernelgen
    from repro_torch.kernels import iaat_gemm
    from repro_torch.models import registry
    from repro_torch.serve import PagedEngine, Request
    from repro_torch.tune import profile as profile_mod
    from repro_torch.tune.classes import SizeClass, representative
    from repro_torch.tune.timer import Measurement
    tuned = api.named_policy("tuned")
    cfg = dataclasses.replace(configs.get_smoke("olmo-1b"), dtype="float32")
    model = registry.build(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    rng = np.random.RandomState(42)
    n = 6
    prompts = [rng.randint(0, cfg.vocab, int(rng.randint(2, 28)))
               for _ in range(n)]
    maxnew = [int(rng.randint(2, 10)) for _ in range(n)]
    arrivals = rng.poisson(2, size=n).cumsum()

    def drive(swaps):
        e = PagedEngine(model, params, tuned, slots=3, max_len=64, eos=-1,
                        block_size=8, chunk=8, num_blocks=8, device="cuda")
        t, nxt = 0, 0
        while nxt < n:
            while nxt < n and arrivals[nxt] <= t:
                e.submit(Request(nxt, prompts[nxt], max_new=maxnew[nxt]))
                nxt += 1
            if t in swaps:
                profile_mod.set_active_profile(swaps[t])
            e.step()
            t += 1
        return e.run(), e

    obs.ROUTES.reset()
    ref, _ = drive({})
    sig = kernelgen.kernel_table("S", "NN")[0]
    profs = []
    for k_us, l_us in ((1.0, 9.0), (9.0, 1.0)):
        p = profile_mod.DeviceProfile(profile_mod.current_device_kind(),
                                      mode="cuda")
        for (_op, letter, cls) in obs.ROUTES.shape_counts():
            p.record(SizeClass.from_key(f"{letter}/NN/{cls}"),
                     profile_mod.ProfileEntry(
                         sig, Measurement(k_us, k_us, k_us, 1),
                         Measurement(l_us, l_us, l_us, 1), "online"))
        profs.append(p)
    iaat_gemm.reset_launch_count()
    out, e = drive({2: profs[0], 5: profs[1], 8: profs[0]})
    launches = iaat_gemm.launch_count("iaat_gemm")
    (op, letter, cls) = next(k for k in obs.ROUTES.shape_counts()
                             if k[0] == "matmul")
    sc = SizeClass.from_key(f"{letter}/NN/{cls}")
    M, N, K = representative(sc)
    flips = []
    for p in profs:
        profile_mod.set_active_profile(p)
        flips.append(api.route("gemm", (M, N, K), letter, "NN",
                               policy=tuned).use_kernel)
    if out != ref or flips != [True, False] or launches <= 0 or \
            len(e.steps_by_gen) < 3:
        raise AssertionError(f"f32 smoke swap parity: tokens equal "
                             f"{out == ref}, decisions {flips}, IAAT "
                             f"launches {launches}, generations "
                             f"{dict(e.steps_by_gen)}")
    return {"requests": n, "identical": True, "iaat_launches": launches,
            "generations": len(e.steps_by_gen)}


#: an installed verdict fails when its path takes at least this many
#: times the other path's time on the idle card: above the spread of
#: the tuner's own timings against the idle card's (0.88-1.11x on
#: NVIDIA H100 80GB HBM3 at 700 W), below the 1.64x and 1.94x by which
#: verdicts taken while the engine shared the card missed
VERDICT_SLACK = 1.25


def _idle_verdicts(torch, online):
    """Each class the online tuner installed, timed again once serving
    has ended, on the idle card, at the shape and with the kernel the
    tuner timed (``search.timed_shape``, the entry's signature and K
    slices) and the library (3 warm-up calls, median of 10): the phase
    fails where the installed path takes :data:`VERDICT_SLACK` times the
    other path's time or more.  Returns the timings per class."""
    from repro_torch import api
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import iaat_gemm
    from repro_torch.tune import search, timer
    from repro_torch.tune.classes import SizeClass
    out, bad = {}, []
    for key, e in sorted(online.items()):
        if e.sig is None or e.library is None or ":" in key:
            continue
        sc = SizeClass.from_key(key)
        M, N, K = search.timed_shape(sc)
        a, b = search._operands(sc, M, N, K, "cuda")
        slices = plan_mod.build_plan(M, N, K, sc.letter, sc.trans,
                                     override=e.sig).regions[0].slices
        kern = timer.measure(lambda: iaat_gemm.gemm_region(
            e.sig, a, b, slices=slices), device="cuda", warmup=3, reps=10)
        lib = timer.measure(lambda: api._lib_gemm(a, b, None, 1.0, 0.0,
                                                  sc.trans),
                            device="cuda", warmup=3, reps=10)
        mine, other = (kern, lib) if e.prefer_kernel else (lib, kern)
        out[key] = {"installed": "kernel" if e.prefer_kernel else "library",
                    "path": e.path, "shape": [M, N, K],
                    "tuner_kernel_us": e.kernel.median_us if e.kernel
                    else None, "tuner_library_us": e.library.median_us,
                    "idle_kernel_us": kern.median_us,
                    "idle_library_us": lib.median_us}
        log(f"online verdict {key} at {M}x{N}x{K} ({e.path}): installed "
            f"{out[key]['installed']} (tuner: kernel "
            f"{out[key]['tuner_kernel_us']} us, library "
            f"{e.library.median_us:.2f} us); idle card: kernel "
            f"{kern.median_us:.2f} us, library {lib.median_us:.2f} us")
        if mine.median_us >= VERDICT_SLACK * other.median_us:
            bad.append(key)
    if bad:
        raise AssertionError(f"online serve: installed verdicts {bad} take "
                             f"{VERDICT_SLACK}x the other path or more on "
                             f"the idle card: {json.dumps(out)}")
    return out


def phase_online_serve(torch, params, card):
    """olmo-1b at full width under ``tuned`` with the online tuner on,
    from an empty profile, through ``launch.serve.serve(online_tune=True,
    trace=...)``: at least one cycle (run by the engine between two
    steps) and one swap, merged
    entries of origin "online" whose kernel times are finite, every
    request complete, every step under one profile generation (the
    engine raises otherwise).  Then the same requests with no tuner,
    from an empty profile again: both tok/s and the requests whose tokens
    differ (bf16: a count, not a gate), and each installed verdict timed
    again on the idle card (:func:`_idle_verdicts`).  Then the f32 smoke
    parity under manual swaps."""
    from repro_torch import obs
    from repro_torch.kernels import iaat_gemm
    from repro_torch.launch import serve as serve_mod
    from repro_torch.tune import profile as profile_mod
    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / "serve_trace.json"
    kw = dict(requests=ONLINE_REQUESTS, slots=4, max_new=ONLINE_MAX_NEW,
              block_size=16, backend="tuned", seed=0, device="cuda",
              params=params)
    with _empty_tune_cache():
        obs.TRACE.reset()
        _reset_counts()
        on = serve_mod.serve("olmo-1b", online_tune=True, trace=path, **kw)
        launches_on = _counts()
        tuner = on["tuner"]
        prof = profile_mod.latest_profile()
        online = {k: e for k, e in (prof.entries.items() if prof else ())
                  if e.origin == "online"}
        timed = {k: e.kernel.median_us for k, e in online.items()
                 if e.kernel is not None and math.isfinite(
                     e.kernel.median_us) and e.kernel.median_us > 0}
        tuner_tickets = (torch.device("cuda", 0),
                         tuner._stream.cuda_stream) in iaat_gemm._tickets \
            if tuner._stream is not None else False
        if tuner.cycles < 1 or tuner.swaps < 1 or not timed:
            raise AssertionError(f"online serve: {tuner.cycles} cycles, "
                                 f"{tuner.swaps} swaps, online entries "
                                 f"{sorted(online)}, timed {timed}")
        if sorted(on["done"]) != list(range(ONLINE_REQUESTS)):
            raise AssertionError(f"online serve: served {sorted(on['done'])}")
        if sum(on["steps_by_gen"].values()) < on["decode_steps"]:
            raise AssertionError(f"online serve: steps {on['steps_by_gen']}")
    with _empty_tune_cache():
        _reset_counts()
        off = serve_mod.serve("olmo-1b", **kw)
    differ = sum(on["done"][i] != off["done"][i]
                 for i in range(ONLINE_REQUESTS))
    idle = _idle_verdicts(torch, online)
    errors = obs.counter("tune.online.errors").value
    log(f"online serve on {card}: olmo-1b, {ONLINE_REQUESTS} requests x "
        f"max_new {ONLINE_MAX_NEW} under tuned: tuner on {on['tok_s']:.2f} "
        f"tok/s ({on['tokens']} tokens in {on['seconds']:.3f}s), off "
        f"{off['tok_s']:.2f} tok/s ({off['seconds']:.3f}s); {tuner.cycles} "
        f"cycles, {tuner.swaps} swaps, {errors} errors; online entries "
        + json.dumps({k: [round(e.kernel.median_us, 2) if e.kernel else
                          None,
                          round(e.library.median_us, 2) if e.library else
                          None, e.prefer_kernel]
                      for k, e in online.items()})
        + f"; timing {tuner.timing()} (warm-up, repeats) a candidate"
        + f"; tuner-stream split tickets {tuner_tickets}; steps per profile "
        f"generation {json.dumps(on['steps_by_gen'])}; {differ}/"
        f"{ONLINE_REQUESTS} requests' tokens differ on/off (bf16)")
    with _empty_tune_cache():
        parity = _smoke_swap_parity(torch)
    log(f"online serve: f32 olmo-smoke under tuned, manual swaps between "
        f"steps: tokens identical to the run with none "
        f"({parity['requests']} requests, {parity['iaat_launches']} IAAT "
        f"launches, {parity['generations']} profile generations)")
    return {"tok_s_on": on["tok_s"], "tok_s_off": off["tok_s"],
            "seconds_on": on["seconds"], "seconds_off": off["seconds"],
            "tokens": on["tokens"], "cycles": tuner.cycles,
            "swaps": tuner.swaps, "errors": errors,
            "online_entries": {k: e.to_json() for k, e in online.items()},
            "idle_verdicts": idle,
            "tuner_stream_tickets": tuner_tickets,
            "steps_by_gen": on["steps_by_gen"],
            "launches_on": launches_on, "tokens_differ": differ,
            "smoke_swap_parity": parity, "trace": str(path)}


def phase_online_grouped(torch, card):
    """One synchronous ``OnlineTuner.cycle()`` on the traffic the moonshot
    serve left in ``ROUTES`` (its ``batched_gemm`` calls among it), with
    a budget for every hot class: at least one ``grouped:`` entry is
    re-timed on the card, with batched launches counted."""
    from repro_torch.kernels import grouped_gemm
    from repro_torch.tune import profile as profile_mod
    from repro_torch.tune.online import OnlineTuner
    tuner = OnlineTuner(top_k=None)
    hot = tuner.targets()
    tuner.budget = 2 * len(hot)         # the library and one candidate each
    with _empty_tune_cache():
        b0 = grouped_gemm.launch_count("batched_gemm")
        t0 = time.perf_counter()
        rep = tuner.cycle()
        dt = time.perf_counter() - t0
        batched = grouped_gemm.launch_count("batched_gemm") - b0
        prof = profile_mod.latest_profile()
        grouped = {k: e for k, e in (prof.entries.items() if prof else ())
                   if k.startswith(profile_mod.GROUPED_PREFIX)
                   and e.origin == "online" and e.kernel is not None}
    if not grouped or batched <= 0 or not rep.swapped:
        raise AssertionError(f"online grouped: {rep}, grouped entries "
                             f"{sorted(grouped)}, batched launches {batched}")
    log(f"online grouped on {card}: one cycle over {len(hot)} hot classes "
        f"of moonshot's traffic in {dt:.3f}s: retuned {rep.retuned}, "
        f"{rep.timings} timings, {batched} batched launches; grouped "
        + json.dumps({k: [round(e.kernel.median_us, 2),
                          round(e.library.median_us, 2) if e.library else
                          None, e.sig.name if e.sig else None]
                      for k, e in grouped.items()}))
    return {"retuned": rep.retuned, "timings": rep.timings,
            "seconds": dt, "batched_launches": batched,
            "grouped": {k: e.to_json() for k, e in grouped.items()}}


def phase_trace(torch, online, card):
    """The Perfetto file of the online serve: it parses, has a track per
    slot, flow-linked request slices and a tuner track with at least one
    ``tune_cycle`` slice; ``python -m repro_torch.obs trace IN OUT``
    re-exports it identically.  Prints the per-request summary."""
    import os
    from repro_torch.obs import trace as trace_mod
    path = pathlib.Path(online["trace"])
    doc = json.loads(path.read_text())
    te = doc["traceEvents"]
    tracks = {(e["pid"], e.get("tid")): e["args"]["name"] for e in te
              if e["ph"] == "M" and e["name"] == "thread_name"}
    slots = {v for v in tracks.values() if v.startswith("slot ")}
    req = [e for e in te if e["ph"] == "X" and e.get("cat") == "request"]
    flows = {e["id"] for e in te if e["ph"] in ("s", "t", "f")}
    cycles = [e for e in te if e["ph"] == "X" and e["name"] == "tune_cycle"
              and tracks.get((e["pid"], e["tid"])) == "online tuner"]
    rids = {e["args"]["rid"] for e in req}
    if slots != {f"slot {s}" for s in range(4)} or \
            rids != set(range(ONLINE_REQUESTS)) or flows != rids or \
            not cycles:
        raise AssertionError(f"trace: slot tracks {sorted(slots)}, request "
                             f"slices of {sorted(rids)}, flows "
                             f"{sorted(flows)}, {len(cycles)} tune cycles")
    again = OUT_DIR / "serve_trace_again.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-m", "repro_torch.obs", "trace",
                    str(path), str(again)], check=True, env=env,
                   capture_output=True, text=True, timeout=300)
    if json.loads(again.read_text()) != doc:
        raise AssertionError("trace: python -m repro_torch.obs trace IN OUT "
                             "did not re-export the file identically")
    per = trace_mod.per_request(trace_mod.load_events(path))
    ttft = sorted(r["ttft_us"] for r in per.values() if "ttft_us" in r)
    summ = trace_mod.summary(per)
    summ.update(ttft_p50_us=ttft[len(ttft) // 2],
                ttft_p99_us=ttft[min(len(ttft) - 1,
                                     math.ceil(0.99 * len(ttft)) - 1)],
                tune_cycles=len(cycles),
                tune_cycle_ms=[round(e["dur"] / 1e3, 3) for e in cycles])
    log(f"trace on {card}: {len(te)} trace events, {len(slots)} slot "
        f"tracks, {len(req)} request slices, {len(cycles)} tune_cycle "
        f"slices; re-exported identically; per request "
        + json.dumps(summ) + f"; tok/s tuner on {online['tok_s_on']:.2f}, "
        f"off {online['tok_s_off']:.2f}")
    return summ


# --------------------------------------------------------------------------
# Every remaining decoder-only family: gemma3-1b, glm4-9b, smollm-360m,
# mixtral-8x22b (4 of 56 layers), zamba2-7b, internvl2-2b.
# --------------------------------------------------------------------------

GEMMA_ARCH, MIXTRAL_ARCH = "gemma3-1b", "mixtral-8x22b"
ZAMBA_ARCH, VLM_ARCH = "zamba2-7b", "internvl2-2b"
DENSE_ARCHS = ("glm4-9b", "smollm-360m")
#: mixtral-8x22b on one card: full width, 4 of its 56 layers (about 20 GB
#: of bf16 weights; all 56 are 282 GB, past the card's 80 GB)
MIXTRAL_LAYERS = 4
#: gemma3's long wave prompt, past its local layers' window of 512
GEMMA_LONG = 1100
#: internvl2's text prompt behind its 1024 frontend tokens
VLM_TEXT = 64


def _free(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _prefill_vs_plain(torch, cfg, params, be, toks, steps, prefix=None):
    """One wave prefill of ``toks`` (after the ``prefix`` embeddings) and
    ``steps`` decode steps under ``be`` and through the plain arithmetic
    (``library``: the chunked oracle), both fed the tokens ``be`` picks;
    every step's logits within STEP_TOL of the largest, and the prefill's
    flash launches one a layer, on the tensor cores.  Returns (the
    prefill's launch counts under ``be``, its seconds, the rel errs)."""
    from repro_torch import api
    from repro_torch.models import lm
    plain = api.Policy(backend="library")
    S = toks.shape[1] + (0 if prefix is None else prefix.shape[1])
    errs = []
    with torch.no_grad():
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lk, ck = lm.prefill(params, cfg, be, toks, cache_len=S + steps,
                            prefix_embeds=prefix)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n = _counts()
        lp, cp = lm.prefill(params, cfg, plain, toks, cache_len=S + steps,
                            prefix_embeds=prefix)
        errs.append(_rel_err(lk, lp)[1])
        for _ in range(steps):
            nxt = lk.argmax(-1, keepdim=True)
            lk, ck = lm.decode(params, cfg, be, nxt, ck)
            lp, cp = lm.decode(params, cfg, plain, nxt, cp)
            errs.append(_rel_err(lk, lp)[1])
    torch.cuda.synchronize()
    if tuple(lk.shape) != (toks.shape[0], cfg.vocab_padded) or \
            not torch.isfinite(lk).all() or ck.pos != S + steps or \
            not all(rel <= STEP_TOL for rel in errs) or \
            n["flash_attention"] != cfg.n_layers or \
            n["flash_tc"] != cfg.n_layers:
        raise AssertionError(f"{cfg.name}: prefill of {S} + {steps} decode "
                             f"steps: launches {n}, rel errs {errs}, logits "
                             f"{tuple(lk.shape)}, position {ck.pos}")
    return n, seconds, errs


def phase_window_step(torch, cfg, params, S=GEMMA_LONG, steps=3):
    """One S-token wave prefill past the window and ``steps`` decode steps
    through the kernels (``kernel``) against the plain arithmetic
    (:func:`_prefill_vs_plain`)."""
    from repro_torch import api
    g = torch.Generator(device="cuda").manual_seed(21)
    toks = torch.randint(0, cfg.vocab, (1, S), generator=g, device="cuda")
    n, _s, errs = _prefill_vs_plain(torch, cfg, params,
                                    api.Policy(backend="kernel"), toks,
                                    steps)
    log(f"window step {cfg.name}: prefill of {S} tokens (window "
        f"{cfg.attn.window} on the local layers) + {steps} decode steps, "
        f"kernel vs plain: rel err per step "
        f"{[float(f'{r:.3g}') for r in errs]} (tol {STEP_TOL}); prefill "
        f"flash launches {n['flash_attention']} ({n['flash_tc']} "
        f"tensor-core), IAAT {n['iaat_gemm']}")
    return {"S": S, "rel_errs": errs, "prefill_launch_counts": n}


def phase_gemma3(torch, cfg):
    """gemma3-1b at full width and depth (26 layers; 16 padded heads of
    256, 5:1 local:global with window 512, a tied vocabulary of 262144):
    PagedEngine and the wave ContinuousBatcher under ``auto`` and the
    forced kernel, the wave's long prompt past the window, a paged decode
    step and the long prompt against the plain arithmetic; the flash
    launches at D 256 and the vocabulary head's IAAT launches printed."""
    runs, params = phase_serve(torch, GEMMA_ARCH, cfg, 6, 16, ["iaat_gemm"])
    out = {"serve": runs, "step": phase_step(torch, cfg, params)}
    out["wave"] = phase_wave_serve(torch, cfg, params,
                                   long_prompt=GEMMA_LONG)
    out["window_step"] = phase_window_step(torch, cfg, params)
    for k, r in list(runs.items()) + list(out["wave"].items()):
        n = r["launch_counts"]
        if not n["iaat_vocab_head"]:
            raise AssertionError(f"gemma3 {k}: the vocab head never took "
                                 f"the IAAT kernel: {n}")
    log(f"gemma3 on the card: IAAT launches on the vocab head (N "
        f"{cfg.vocab_padded}) " + json.dumps(
            {k: r["launch_counts"]["iaat_vocab_head"] for k, r in
             list(runs.items()) + [(f"wave {k}", r) for k, r in
                                   out["wave"].items()]})
        + "; flash launches at D 256 (tensor-core) " + json.dumps(
            {f"wave {k}": r["launch_counts"]["flash_tc"]
             for k, r in out["wave"].items()}))
    del params
    _free(torch)
    return out


def phase_paged(torch, arch, cfg, requests=4, max_new=8,
                kernels=("iaat_gemm",)):
    """A config at full width (and the depth ``cfg`` has) on PagedEngine
    under ``auto`` and the forced kernel (:func:`phase_serve`: every
    kernel of ``kernels`` launched, every IAAT launch on the ring, every
    expert GEMM a batched launch on the mma ring), and one decode step
    against the plain arithmetic (:func:`phase_step`): glm4-9b,
    smollm-360m, and mixtral-8x22b at :data:`MIXTRAL_LAYERS` layers."""
    runs, params = phase_serve(torch, arch, cfg, requests, max_new,
                               list(kernels))
    out = {"serve": runs, "step": phase_step(torch, cfg, params)}
    del params
    _free(torch)
    return out


def _hybrid_layerwise(torch, cfg, params, toks, auto, plain):
    """The bf16 forward block by block, each on the plain path's input:
    the shared block's attention (flash against the chunked oracle) and
    every mamba mixer (the SSD kernel against ``ref_ssd``) under ``auto``
    and through the plain arithmetic, each output within STEP_TOL of its
    largest value; the plain path's output feeds the next block.  This is
    how zamba2's bf16 forward is held: over 81 layers a one-step bf16
    rounding flip of one block's output (flash and the chunked oracle
    round once each; the scan's f32 output rounds to bf16 at the gate)
    grew past STEP_TOL of the largest logit (0.087 in this phase's first
    run, NVIDIA H100 80GB HBM3, 700 W), while the forward with the weights
    widened to f32 is held at the logits.  Returns the worst (max abs
    err, rel err, block)."""
    from repro_torch.models import common, layers, lm, ssm
    worst = (0.0, 0.0, None)

    def held(what, f):
        nonlocal worst
        want = f(plain)
        ab, rel = _rel_err(f(auto), want)
        if rel > worst[1]:
            worst = (ab, rel, what)
        return want

    with torch.no_grad():
        x = lm._embed_tokens(params, cfg, toks)
        for i, blk in enumerate(params.blocks):
            sh = params.shared
            if lm._shared_app(cfg, i) is not None:
                h = common.rmsnorm(x, sh.ln1, cfg.norm_eps)
                x = x + held(f"shared attention before layer {i}",
                             lambda be: layers.attention(
                                 sh.attn, h, be, cfg,
                                 window=lm._window_for_layer(cfg, i))[0])
                h = common.rmsnorm(x, sh.ln2, cfg.norm_eps)
                x = x + layers.mlp(sh.mlp, h, plain)
            h = common.rmsnorm(x, blk.ln1, cfg.norm_eps)
            x = x + held(f"mamba {i}",
                         lambda be: ssm.mamba(blk.mixer, h, be, cfg))
    return worst


def phase_hybrid_forward(torch, cfg, params, Bt=2, S=2048):
    """One zamba2-7b forward_train over Bt x S tokens under ``auto``
    (timed: the SSD kernel in every mamba layer, flash at D 112 padded to
    the tensor-core instance at 128 in each of the shared block's
    applications, the M = 4096 GEMMs on the library) and through the
    plain arithmetic (``library``): in bf16 each block within STEP_TOL
    (:func:`_hybrid_layerwise`; the logits' error is reported); then the same
    with the weights widened to f32 (in place: the phase is their last
    user), the logits within FWD_F32_TOL."""
    import dataclasses
    from repro_torch import api
    from repro_torch.kernels import ssd
    from repro_torch.models import lm
    auto, plain = api.Policy(backend="auto"), api.Policy(backend="library")
    g = torch.Generator(device="cuda").manual_seed(29)
    toks = torch.randint(0, cfg.vocab, (Bt, S), generator=g, device="cuda")
    napps = lm._n_shared_apps(cfg)
    out = {"Bt": Bt, "S": S, "applications": napps}

    def both(c):
        with torch.no_grad():
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            la, _ = lm.forward_train(params, c, auto, toks)
            torch.cuda.synchronize()
            t_auto = time.perf_counter() - t0
            n = _counts()
            t0 = time.perf_counter()
            lp, _ = lm.forward_train(params, c, plain, toks)
            torch.cuda.synchronize()
            t_lib = time.perf_counter() - t0
        if tuple(la.shape) != (Bt, S, c.vocab_padded) or not (
                torch.isfinite(la).all() and torch.isfinite(lp).all()):
            raise AssertionError(f"hybrid forward logits {tuple(la.shape)}"
                                 ", or non-finite")
        ab, rel = _rel_err(la, lp)
        return n, t_auto, t_lib, ab, rel

    per = ssd.launches_per_scan(S, cfg.ssm.chunk)

    def held_to_kernels(n, instance):
        # every mamba layer's scan and every shared application's flash
        # on the kernel, flash on the instance its dtype takes
        if n["ssd_scans"] != cfg.n_layers or \
                n["ssd_scan"] != cfg.n_layers * per or \
                n["flash_attention"] != napps or n[instance] != napps:
            raise AssertionError(
                f"hybrid forward under auto: launches {n}, want "
                f"{cfg.n_layers} scans of {per} and {napps} flash "
                f"launches on {instance}")

    n, out["auto_s"], out["library_s"], ab, rel = both(cfg)
    held_to_kernels(n, "flash_tc")
    lab, lrel, where = _hybrid_layerwise(torch, cfg, params, toks, auto,
                                         plain)
    out.update(launch_counts=n, max_abs_err=ab, rel_err=rel,
               layer_max_abs_err=lab, layer_rel_err=lrel, worst_block=where)
    log(f"hybrid forward {cfg.name} {Bt}x{S}: auto {out['auto_s']:.3f} s "
        f"(SSD {n['ssd_scans']} scans of {n['ssd_scan']} launches, flash "
        f"{n['flash_attention']} launches at D {cfg.head_dim_} padded to "
        f"128, {n['flash_tc']} on the tensor cores, IAAT {n['iaat_gemm']}),"
        f" library {out['library_s']:.3f} s; logits max abs err {ab:.4g}, "
        f"rel {rel:.3g}; layer by layer worst rel {lrel:.3g} ({where}, max "
        f"abs {lab:.4g}; tol {STEP_TOL})")
    if not lrel <= STEP_TOL:
        raise AssertionError(f"hybrid forward, {where}: rel err {lrel} > "
                             f"{STEP_TOL}")
    for w in [params.embed, params.unembed] + [
            t for blk in params.blocks
            for t in (blk.mixer.in_proj, blk.mixer.out_proj)] + [
            getattr(m, k) for m, ks in ((params.shared.attn, "wq wk wv wo"),
                                        (params.shared.mlp, "wg wu wd"))
            for k in ks.split()]:
        if w is not None:
            w.data = w.data.float()
    n32, _, _, ab32, rel32 = both(dataclasses.replace(cfg, dtype="float32"))
    held_to_kernels(n32, "flash_cuda_core")
    out.update(f32_max_abs_err=ab32, f32_rel_err=rel32,
               f32_launch_counts=n32)
    log(f"hybrid forward {cfg.name} {Bt}x{S}, weights widened to f32: "
        f"logits max abs err {ab32:.4g}, rel {rel32:.3g} (tol "
        f"{FWD_F32_TOL}); flash launches {n32['flash_attention']} "
        f"(CUDA-core {n32['flash_cuda_core']})")
    if not rel32 <= FWD_F32_TOL:
        raise AssertionError(f"f32 hybrid forward rel err {rel32} > "
                             f"{FWD_F32_TOL}")
    return out


def phase_zamba2(torch, cfg):
    """zamba2-7b at full width and depth (81 mamba layers at d 3584,
    d_state 64, one shared attention block applied 14 times, head dim
    112) on PagedEngine under ``auto`` and the forced kernel (IAAT
    launches > 0; no SSD or flash launch: serving runs the token
    recurrence and paged attention in plain ops), then its forward_train
    (:func:`phase_hybrid_forward`)."""
    runs, params = phase_serve(torch, ZAMBA_ARCH, cfg, 6, 16, ["iaat_gemm"])
    for backend, r in runs.items():
        n = r["launch_counts"]
        if n["ssd_scan"] or n["flash_attention"]:
            raise AssertionError(f"{ZAMBA_ARCH} {backend}: serving "
                                 f"launched the SSD or flash kernel: {n}")
    out = {"serve": runs,
           "forward": phase_hybrid_forward(torch, cfg, params)}
    del params
    _free(torch)
    return out


def phase_vlm(torch, cfg, steps=4):
    """internvl2-2b at full width and depth: a short paged serve of text
    (the reference's engine serves VLM text) under ``auto`` and the
    forced kernel; then one prefill of 1024 ``fake_frontend`` embeddings
    plus a :data:`VLM_TEXT`-token prompt and ``steps`` decode steps under
    ``auto`` against the plain arithmetic (:func:`_prefill_vs_plain`)."""
    from repro_torch import api
    from repro_torch.models import frontends
    runs, params = phase_serve(torch, VLM_ARCH, cfg, 4, 8, ["iaat_gemm"])
    g = torch.Generator(device="cuda").manual_seed(23)
    pre = frontends.fake_frontend(g, cfg, 1, 0, cfg.compute_dtype, "cuda")
    toks = torch.randint(0, cfg.vocab, (1, VLM_TEXT), generator=g,
                         device="cuda")
    n, prefill_s, errs = _prefill_vs_plain(
        torch, cfg, params, api.Policy(backend="auto"), toks, steps, pre)
    log(f"vlm prefill {cfg.name}: {pre.shape[1]} frontend + {VLM_TEXT} text "
        f"tokens in {prefill_s:.3f} s under auto (flash "
        f"{n['flash_attention']} launches, {n['flash_tc']} tensor-core; "
        f"IAAT {n['iaat_gemm']}); kernel vs plain rel err per step "
        f"{[float(f'{r:.3g}') for r in errs]} (tol {STEP_TOL})")
    del params
    _free(torch)
    return {"serve": runs, "prefill_s": prefill_s, "prefix": pre.shape[1],
            "text": VLM_TEXT, "prefill_launch_counts": n, "rel_errs": errs}


def _batched_row(torch, mcfg, K, N, C=None, what="expert GEMM"):
    """batched_gemm / plain / torch.bmm times (loop and device) and the
    bound at one of an MoE model's expert GEMMs, E experts x C rows
    (default: the decode capacity of 4 slots), bf16: mixtral's at decode
    (one call reads 8 K N weights, >= 1.6 GB, from HBM), moonshot's in
    forward_train."""
    from repro_torch.core import cost
    from repro_torch.kernels import grouped_gemm as gg
    g = torch.Generator(device="cuda").manual_seed(41)
    bf = torch.bfloat16
    E = mcfg.moe.num_experts
    C = _decode_capacity(mcfg) if C is None else C
    x = torch.randn((E, C, K), generator=g, device="cuda").to(bf)
    w = (torch.randn((E, K, N), generator=g, device="cuda") /
         math.sqrt(K)).to(bf)
    blocks = gg.pick_blocks(C, K, N, bf)
    _, rel = _rel_err(gg.batched_gemm(x, w, blocks=blocks),
                      gg.batched_gemm_plain(x, w))
    if not rel <= TOL["H"]:
        raise AssertionError(f"batched_gemm mixtral K={K} N={N}: rel err "
                             f"{rel}")
    t = {"ms": _time_ms(torch, lambda i: gg.batched_gemm(
        x, w, blocks=blocks), 20),
         "plain_ms": _time_ms(torch, lambda i: gg.batched_gemm_plain(x, w),
                              5),
         "library_ms": _time_ms(torch, lambda i: torch.bmm(x, w), 20),
         "device_ms": _device_ms(torch, lambda i: gg.batched_gemm(
             x, w, blocks=blocks), 10, "grouped_gemm_kernel")[0],
         "library_device_ms": _device_ms(torch, lambda i: torch.bmm(x, w),
                                         10)[0]}
    flops, nbytes = 2 * E * C * K * N, 2 * (E * C * K + E * K * N + E * C * N)
    t_ops, t_bytes = flops / cost.PEAK_FLOPS_BF16, nbytes / cost.HBM_BW
    path, slices = gg.launch_plan(x, w, blocks)
    row = {"kernel": "batched_gemm", "at": f"{mcfg.name} {what}",
           "G": E, "C": C, "K": K, "N": N, **t,
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "path": path, "slices": slices, "rel_err": rel}
    log(f"kernel time batched_gemm {mcfg.name} H {E} x C={C} K={K} N={N} "
        f"({path}, {slices} K slices): kernel {t['ms']:.4f} ms (device "
        f"{t['device_ms']} ms), plain {t['plain_ms']:.4f} ms, library "
        f"torch.bmm {t['library_ms']:.4f} ms (device "
        f"{t['library_device_ms']} ms), bound {row['bound_ms']:.4f} ms")
    return row


def phase_slice_kernels(torch, launches):
    """The slice's new kernel shapes, each timed against its plain
    version, its library call and its bound: the IAAT kernel on gemma3's
    tied 262144-entry vocabulary head and glm4's d 4096 / d_ff 13696
    projections (M = 4, decode), flash at gemma3's D 256 with window 512
    (its 1100-token prompt, 16 padded heads over 4 KV heads) and at
    zamba2's D 112 (the forward's 2 x 2048 tokens, padded to 128),
    mixtral's expert GEMMs on batched_gemm and zamba2's SSD scan at
    d_state 64.  ``launches[kernel][arch]`` is the kernel's count on that
    model's main path, from the phases above; each row gets its model's.
    Returns rows per kernel."""
    from repro_torch import configs
    gem = configs.get_config(GEMMA_ARCH)
    glm = configs.get_config("glm4-9b")
    mix = _mixtral_cfg()
    zam = configs.get_config(ZAMBA_ARCH)
    rows = {"iaat_gemm": [
        _iaat_row(torch, 4, gem.d_model, gem.vocab_padded, True,
                    "gemma3-1b vocab head")] + [
        _iaat_row(torch, 4, K, N, False, f"glm4-9b {what}")
        for what, K, N in (("q/o", glm.d_model, glm.d_model),
                           ("gate/up", glm.d_model, glm.d_ff),
                           ("down", glm.d_ff, glm.d_model))]}
    rows["flash_attention"] = [
        _flash_row(torch, 1, gem.n_heads_padded, gem.n_kv_heads_padded,
                     GEMMA_LONG, gem.head_dim_, gem.attn.window,
                     "gemma3-1b local layer, long prompt"),
        _flash_row(torch, 2, zam.n_heads_padded, zam.n_kv_heads_padded,
                     2048, zam.head_dim_, None,
                     "zamba2-7b shared block, forward_train")]
    rows["batched_gemm"] = [
        _batched_row(torch, mix, K, N)
        for K, N in _grouped_decode_shapes(mix)]
    _entry, ssd_rows = phase_ssd_kernels(torch, zam, 0)
    ssd_rows[0]["at"] = "zamba2-7b forward_train layer"
    rows["ssd_scan"] = ssd_rows
    for name, rs in rows.items():
        for r in rs:
            r["main_path_launches"] = launches.get(name, {}).get(
                r["at"].split()[0])
    return rows


# --------------------------------------------------------------------------
# The enc-dec family (seamless-m4t-large-v2) and forward_train for the
# attention families.
# --------------------------------------------------------------------------

ENCDEC_ARCH = "seamless-m4t-large-v2"
#: requests, encoder frames (not a multiple of flash's 64-key tile),
#: decoder prompt tokens and new tokens of the enc-dec phase; the forced
#: kernel's run decodes one request for ENCDEC_FORCED_STEPS steps (its
#: encoder GEMMs at M = 1000 run on the IAAT kernel)
ENCDEC_B, ENCDEC_SRC, ENCDEC_PROMPT, ENCDEC_NEW = 4, 1000, 4, 32
ENCDEC_FORCED_STEPS = 4
#: greedy steps of the f32 comparison with the library
ENCDEC_F32_STEPS = 8


def _flash_launches(n, want, what, instance="flash_tc"):
    """``want`` flash launches in ``n``, every one on ``instance`` (the
    tensor cores for bf16 at D 64/128/256, "flash_cuda_core" for f32)."""
    if n["flash_attention"] != want or n[instance] != want:
        raise AssertionError(f"{what}: flash launches {n['flash_attention']}"
                             f" ({n['flash_tc']} tensor-core), want {want}, "
                             f"all on {instance}")


def _encdec_greedy(torch, model, params, be, toks, src, new):
    """Greedy decoding of ``new`` tokens: prefill of toks (B, S) over src
    (B, S_src, d), then new - 1 decode steps, each timed to its end on
    the card and its launches counted.  Under a policy that uses the
    kernels: flash n_enc + 2 n_dec launches a prefill and n_dec a step
    (the cross attention at Sq = 1), all on the dtype's instance; IAAT
    launches > 0 a step, every one on the ring.  Returns the tokens
    (B, new), the logits of each step and the numbers."""
    from repro_torch import obs
    cfg = model.cfg
    B, S = toks.shape
    inst = "flash_tc" if cfg.compute_dtype == torch.bfloat16 else \
        "flash_cuda_core"
    kernels = be.use_kernels
    with torch.no_grad():
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, toks, be, cache_len=S + new,
                                      src_embeds=src)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        n_prefill = _counts()
        share = list(obs.ROUTES.kernel_share())
        if kernels:
            _flash_launches(n_prefill, cfg.n_encoder_layers +
                            2 * cfg.n_layers, f"{cfg.name} prefill", inst)
        out, all_logits, step_s, step_n = [logits.argmax(-1)], [logits], \
            [], []
        for _ in range(new - 1):
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.decode(params, out[-1][:, None], cache, be)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            n = _counts()
            step_n.append(n)
            share = [a + b for a, b in zip(share,
                                           obs.ROUTES.kernel_share())]
            if kernels:
                _flash_launches(n, cfg.n_layers, f"{cfg.name} decode step",
                                inst)
                if not n["iaat_gemm"] or n["iaat_scalar"] or \
                        n["iaat_ring"] != n["iaat_gemm"]:
                    raise AssertionError(f"{cfg.name} decode step: IAAT "
                                         f"launches off the ring or none: "
                                         f"{n}")
            out.append(logits.argmax(-1))
            all_logits.append(logits)
    tokens = torch.stack(out, 1)
    if cache.pos != S + new - 1 or not all(
            bool(torch.isfinite(lg).all()) for lg in all_logits) or \
            not bool(((tokens >= 0) & (tokens < cfg.vocab_padded)).all()):
        raise AssertionError(f"{cfg.name} greedy: position {cache.pos}, "
                             "non-finite logits or tokens out of range")
    total = prefill_s + sum(step_s)
    return tokens, all_logits, {
        "B": B, "prompt": S, "src": src.shape[1], "new": new,
        "prefill_s": prefill_s,
        "decode_step_s": sum(step_s) / max(len(step_s), 1),
        "tok_s": B * new / total, "seconds": total,
        "prefill_launch_counts": n_prefill,
        "decode_step_iaat": [n["iaat_gemm"] for n in step_n],
        "decode_step_flash": [n["flash_attention"] for n in step_n],
        "routed_to_kernel": share[0], "routed": share[1]}


def _encdec_blockwise(torch, cfg, params, toks, src, auto, plain):
    """The bf16 forward of the prompt toks (B, S) over src, block by block,
    each sublayer (every encoder layer's attention and mlp, every decoder
    layer's self attention, cross attention and mlp) under ``auto`` and
    through the plain arithmetic on the plain path's input, each output
    within STEP_TOL of its largest value; the plain path's output feeds
    the next sublayer.  Returns the worst (max abs err, rel err,
    sublayer)."""
    from repro_torch.models import encdec, layers as L
    from repro_torch.models.common import rmsnorm
    worst = (0.0, 0.0, None)
    eps = cfg.norm_eps

    def held(what, f):
        nonlocal worst
        want = f(plain)
        ab, rel = _rel_err(f(auto), want)
        if rel > worst[1]:
            worst = (ab, rel, what)
        return want

    with torch.no_grad():
        x = src.to(cfg.compute_dtype)
        for i, blk in enumerate(params.enc_blocks):
            h = rmsnorm(x, blk.ln1, eps)
            x = x + held(f"encoder {i} attention", lambda be: L.attention(
                blk.attn, h, be, cfg, causal=False)[0])
            h = rmsnorm(x, blk.ln2, eps)
            x = x + held(f"encoder {i} mlp",
                         lambda be: L.mlp(blk.mlp, h, be))
        enc = rmsnorm(x, params.enc_norm, eps)
        x = params.embed[toks].to(cfg.compute_dtype)
        for i, blk in enumerate(params.dec_blocks):
            cross = encdec._cross_kv(blk, enc, cfg, plain)
            h = rmsnorm(x, blk.ln1, eps)
            x = x + held(f"decoder {i} self attention", lambda be:
                         L.attention(blk.self_attn, h, be, cfg)[0])
            h = rmsnorm(x, blk.ln_x, eps)
            x = x + held(f"decoder {i} cross attention", lambda be:
                         L.attention(blk.cross_attn, h, be, cfg,
                                     cross_kv=cross))
            h = rmsnorm(x, blk.ln2, eps)
            x = x + held(f"decoder {i} mlp",
                         lambda be: L.mlp(blk.mlp, h, be))
    return worst


def phase_encdec(torch, cfg):
    """seamless-m4t-large-v2 at full width and depth (24 encoder and 24
    decoder layers, d 1024, 16 heads of 64, vocab 256256 untied; random
    bf16 weights from a seeded torch.Generator, fake_frontend frames)
    through ``registry.build(cfg)``'s prefill and decode:

    a. greedy decoding of ENCDEC_B requests (ENCDEC_SRC frames, prompts
       of ENCDEC_PROMPT tokens, ENCDEC_NEW new tokens) and of one request
       under ``auto``, then one request for ENCDEC_FORCED_STEPS steps
       under the forced kernel (:func:`_encdec_greedy`: flash 24 launches
       an encode, 72 a prefill, 24 a decode step, all tensor-core; IAAT
       launches > 0 a decode step, all on the ring; the routed GEMMs'
       share to the kernel);
    c. bf16: prefill and one decode step under ``auto`` against the
       plain arithmetic (``library``) within STEP_TOL of the largest
       logit, and block by block (:func:`_encdec_blockwise`); it passes
       if the whole stack or every block is within STEP_TOL, and says
       which held;
    b. the weights widened to f32 (in place: the phase is their last
       user): ENCDEC_F32_STEPS greedy steps under ``auto`` and
       ``library`` within FWD_F32_TOL of the largest logit, the tokens
       identical; forward_train over 33 tokens against prefill of 32 and
       one decode step, within FWD_F32_TOL (the reference's consistency
       test at full size)."""
    import dataclasses
    from repro_torch import api
    from repro_torch.models import encdec, frontends, registry
    auto, plain = api.Policy(backend="auto"), api.Policy(backend="library")
    kern = api.Policy(backend="kernel")
    model = registry.build(cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(g, "cuda")
    nparams = sum(p.numel() for p in params.parameters())
    src = frontends.fake_frontend(g, cfg, ENCDEC_B, ENCDEC_SRC,
                                  cfg.compute_dtype, "cuda")
    toks = torch.randint(0, cfg.vocab, (ENCDEC_B, ENCDEC_PROMPT),
                         generator=g, device="cuda")
    out = {"params": nparams, "src": ENCDEC_SRC}
    with torch.no_grad():       # warm-up, not counted
        model.prefill(params, toks[:1], auto, src_embeds=src[:1])
        _reset_counts()
        enc = encdec.encode(params, cfg, auto, src)
        torch.cuda.synchronize()
        n_enc = _counts()
        _flash_launches(n_enc, cfg.n_encoder_layers, f"{cfg.name} encode")
        del enc
    out["encode_launch_counts"] = n_enc
    runs = out["greedy"] = {}
    for name, be, b, new in (
            (f"auto B{ENCDEC_B}", auto, ENCDEC_B, ENCDEC_NEW),
            ("auto B1", auto, 1, ENCDEC_NEW),
            ("kernel B1", kern, 1, ENCDEC_FORCED_STEPS + 1)):
        _tok, _lg, r = _encdec_greedy(torch, model, params, be, toks[:b],
                                      src[:b], new)
        runs[name] = r
        log(f"encdec {cfg.name} [{name}]: {b} x ({ENCDEC_SRC} frames, "
            f"{ENCDEC_PROMPT} prompt tokens, {new} new): {r['tok_s']:.2f} "
            f"tok/s, prefill (encode included) {r['prefill_s']:.4f} s, "
            f"decode step {r['decode_step_s'] * 1e3:.3f} ms; launches: "
            f"encode flash {n_enc['flash_attention']}, prefill "
            f"{json.dumps(r['prefill_launch_counts'])}, IAAT a decode step "
            f"{r['decode_step_iaat'][0]} (all ring), flash a decode step "
            f"{r['decode_step_flash'][0]} (tensor-core); routed GEMMs to "
            f"the kernel {r['routed_to_kernel']}/{r['routed']}")
    # c. bf16 against the plain arithmetic
    with torch.no_grad():
        la, ca = model.prefill(params, toks, auto, cache_len=ENCDEC_PROMPT
                               + 1, src_embeds=src)
        lp, cp = model.prefill(params, toks, plain, cache_len=ENCDEC_PROMPT
                               + 1, src_embeds=src)
        nxt = la.argmax(-1, keepdim=True)
        errs = [_rel_err(la, lp)[1]]
        la, _ = model.decode(params, nxt, ca, auto)
        lp, _ = model.decode(params, nxt, cp, plain)
        errs.append(_rel_err(la, lp)[1])
        del ca, cp
    lab, lrel, where = _encdec_blockwise(
        torch, cfg, params, torch.cat([toks, nxt], 1), src, auto, plain)
    whole = all(r <= STEP_TOL for r in errs)
    out["bf16"] = {"rel_errs": errs, "block_rel_err": lrel,
                   "block_max_abs_err": lab, "worst_block": where,
                   "held": "whole stack" if whole else "block by block"}
    log(f"encdec {cfg.name} bf16, auto vs plain: prefill and one decode "
        f"step rel err {[float(f'{r:.3g}') for r in errs]}; block by block "
        f"worst rel {lrel:.3g} ({where}, max abs {lab:.4g}); tol "
        f"{STEP_TOL}: held {out['bf16']['held']}")
    if not whole and not lrel <= STEP_TOL:
        raise AssertionError(f"encdec bf16: rel errs {errs}, worst block "
                             f"{where} {lrel} > {STEP_TOL}")
    # b. f32 at full width
    for p in params.parameters():
        p.data = p.data.float()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = registry.build(cfg32)
    src32 = src.float()
    ta, lga, _ = _encdec_greedy(torch, m32, params, auto, toks, src32,
                                ENCDEC_F32_STEPS)
    tp, lgp, _ = _encdec_greedy(torch, m32, params, plain, toks, src32,
                                ENCDEC_F32_STEPS)
    f32_errs = [_rel_err(a, b)[1] for a, b in zip(lga, lgp)]
    same = bool(torch.equal(ta, tp))
    with torch.no_grad():
        t33 = torch.randint(0, cfg.vocab, (ENCDEC_B, 33), generator=g,
                            device="cuda")
        full, aux = m32.forward_train(params, t33, auto, src32)
        lp, cache = m32.prefill(params, t33[:, :32], auto, cache_len=33,
                                src_embeds=src32)
        ld, _ = m32.decode(params, t33[:, 32:], cache, auto)
        scale = full.abs().max().item()
        cons = [(lp - full[:, -2]).abs().max().item() / scale,
                (ld - full[:, -1]).abs().max().item() / scale]
    out["f32"] = {"rel_errs": f32_errs, "tokens_identical": same,
                  "consistency": cons, "aux": float(aux)}
    log(f"encdec {cfg.name} f32 (weights widened), auto vs library over "
        f"{ENCDEC_F32_STEPS} greedy steps: rel err per step "
        f"{[float(f'{r:.3g}') for r in f32_errs]} (tol {FWD_F32_TOL}), "
        f"tokens identical {same}; forward_train of 33 tokens vs prefill "
        f"of 32 + one decode step: {[float(f'{c:.3g}') for c in cons]} "
        f"(tol {FWD_F32_TOL}), aux {float(aux)}")
    if not (same and all(r <= FWD_F32_TOL for r in f32_errs + cons)
            and float(aux) == 0.0):
        raise AssertionError(f"encdec f32: tokens identical {same}, rel "
                             f"errs {f32_errs}, consistency {cons}, aux "
                             f"{float(aux)}")
    del params
    _free(torch)
    return out


def phase_encdec_step(torch, cfg):
    """One seamless-m4t-large-v2 decode step at B ENCDEC_B under ``auto``
    (the weights, frames and prompts of :func:`phase_encdec`, drawn
    again): its loop time (host included) and its torch.profiler device
    time, the sum of its some two thousand device kernels.  Run after the
    other device-time phases: a trace of that many kernels left the
    later traces of one run without device events (NVIDIA H100 80GB
    HBM3, 700 W)."""
    from repro_torch import api
    from repro_torch.models import frontends, registry
    auto = api.Policy(backend="auto")
    model = registry.build(cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(g, "cuda")
    src = frontends.fake_frontend(g, cfg, ENCDEC_B, ENCDEC_SRC,
                                  cfg.compute_dtype, "cuda")
    toks = torch.randint(0, cfg.vocab, (ENCDEC_B, ENCDEC_PROMPT),
                         generator=g, device="cuda")
    with torch.no_grad():
        logits, cache = model.prefill(params, toks, auto,
                                      cache_len=ENCDEC_PROMPT + 1,
                                      src_embeds=src)
        nxt = logits.argmax(-1, keepdim=True)

        def step(i):
            # every call writes the same cache slot
            return model.decode(params, nxt, cache, auto)
        loop_ms = _time_ms(torch, step, 10)
        device_ms, kernels = _device_ms(torch, step, 1)
    log(f"encdec step {cfg.name} at B {ENCDEC_B} under auto: loop "
        f"{loop_ms:.3f} ms, device {device_ms} ms over {kernels} device "
        "kernels")
    del params, cache
    _free(torch)
    return {"B": ENCDEC_B, "loop_ms": loop_ms, "device_ms": device_ms,
            "device_kernels": kernels}


def phase_forward(torch, cfg, params, Bt=2, S=2048):
    """olmo-1b's forward_train over Bt x S tokens under ``auto`` (timed:
    flash once a layer, causal at S 2048, on the tensor cores; the M =
    4096 GEMMs on the library) and through the plain arithmetic
    (``library``): logits within STEP_TOL of the largest, the aux loss
    exactly 0 in both."""
    from repro_torch import api
    from repro_torch.models import lm
    auto, plain = api.Policy(backend="auto"), api.Policy(backend="library")
    g = torch.Generator(device="cuda").manual_seed(43)
    toks = torch.randint(0, cfg.vocab, (Bt, S), generator=g, device="cuda")
    with torch.no_grad():
        lm.forward_train(params, cfg, auto, toks[:, :64])    # warm-up
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        la, aux = lm.forward_train(params, cfg, auto, toks)
        torch.cuda.synchronize()
        t_auto = time.perf_counter() - t0
        n = _counts()
        t0 = time.perf_counter()
        lp, auxp = lm.forward_train(params, cfg, plain, toks)
        torch.cuda.synchronize()
        t_lib = time.perf_counter() - t0
    ab, rel = _rel_err(la, lp)
    log(f"forward {cfg.name} {Bt}x{S}: auto {t_auto:.3f} s (flash "
        f"{n['flash_attention']} launches, {n['flash_tc']} tensor-core; IAAT "
        f"{n['iaat_gemm']}), library {t_lib:.3f} s; logits max abs err "
        f"{ab:.4g}, rel {rel:.3g} (tol {STEP_TOL}); aux {float(aux)} / "
        f"{float(auxp)}")
    _flash_launches(n, cfg.n_layers, f"{cfg.name} forward_train")
    if tuple(la.shape) != (Bt, S, cfg.vocab_padded) or not (
            torch.isfinite(la).all() and torch.isfinite(lp).all()) or \
            not rel <= STEP_TOL or float(aux) != 0.0 or float(auxp) != 0.0:
        raise AssertionError(f"forward {cfg.name}: logits "
                             f"{tuple(la.shape)}, rel err {rel}, aux "
                             f"{float(aux)} / {float(auxp)}")
    return {"Bt": Bt, "S": S, "auto_s": t_auto, "library_s": t_lib,
            "launch_counts": n, "max_abs_err": ab, "rel_err": rel}


def phase_moe_forward(torch, cfg, params, S=2048):
    """moonshot-v1-16b-a3b's forward_train over 1 x S tokens (its weights
    as "moe serve" loaded them) under ``auto`` (timed) and through the
    plain arithmetic: flash once a layer on the tensor cores; the
    batched_gemm launches exactly the expert GEMMs ``api.route`` sends
    to the kernel at the forward's capacity C, three a layer at most;
    the aux loss within 1e-3 of the library run's, relative.  bf16
    expert choices flip between the two runs, so the logits are held
    block by block: each layer's attention and MoE on the plain run's
    input, the plain MoE pinned to the expert choices of the run under
    ``auto`` (``_ExpertChoices``), each within STEP_TOL."""
    from repro_torch import api
    from repro_torch.models import layers, lm
    from repro_torch.models.common import rmsnorm
    auto, plain = api.Policy(backend="auto"), api.Policy(backend="library")
    g = torch.Generator(device="cuda").manual_seed(47)
    toks = torch.randint(0, cfg.vocab, (1, S), generator=g, device="cuda")
    m, d = cfg.moe, cfg.d_model
    E, C = m.num_experts, layers._capacity(S, m)
    want = cfg.n_layers * sum(
        api.route("batched_gemm", (E, C, K, N), cfg.compute_dtype,
                  policy=auto).use_kernel
        for K, N in ((d, m.d_expert), (d, m.d_expert), (m.d_expert, d)))
    with torch.no_grad():
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _ExpertChoices(layers) as ca:
            la, aux = lm.forward_train(params, cfg, auto, toks)
        torch.cuda.synchronize()
        t_auto = time.perf_counter() - t0
        n = _counts()
        t0 = time.perf_counter()
        with _ExpertChoices(layers) as cp:
            lp, auxp = lm.forward_train(params, cfg, plain, toks)
        torch.cuda.synchronize()
        t_lib = time.perf_counter() - t0
    ab, rel = _rel_err(la, lp)
    aux_rel = abs(float(aux) - float(auxp)) / abs(float(auxp))
    # (token, layer) top-k expert sets the two whole runs chose apart
    flipped = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1)
                      .sum()) for a, b in zip(ca.seen, cp.seen))
    worst = (0.0, 0.0, None)

    def held(what, ya, yp):
        nonlocal worst
        a, r = _rel_err(ya, yp)
        if r > worst[1]:
            worst = (a, r, what)

    with torch.no_grad():
        x = lm._embed_tokens(params, cfg, toks)
        for i, blk in enumerate(params.blocks):
            h = rmsnorm(x, blk.ln1, cfg.norm_eps)
            ya, yp = (layers.attention(blk.attn, h, be, cfg)[0]
                      for be in (auto, plain))
            held(f"attention {i}", ya, yp)
            x = x + yp
            h = rmsnorm(x, blk.ln2, cfg.norm_eps)
            with _ExpertChoices(layers) as ck:
                ya = layers.moe(blk.moe, h, auto, cfg)[0]
            with _ExpertChoices(layers, pinned=ck.seen):
                yp = layers.moe(blk.moe, h, plain, cfg)[0]
            held(f"moe {i}", ya, yp)
            x = x + yp
    lab, lrel, where = worst
    log(f"moe forward {cfg.name} 1x{S}: auto {t_auto:.3f} s (flash "
        f"{n['flash_attention']} launches, {n['flash_tc']} tensor-core; "
        f"batched_gemm {n['batched_gemm']} launches at C {C}, want {want} "
        f"as api.route sends them; IAAT {n['iaat_gemm']}), library "
        f"{t_lib:.3f} s; aux {float(aux):.6g} vs {float(auxp):.6g} (rel "
        f"{aux_rel:.3g}, tol 1e-3); whole logits rel err {rel:.3g} "
        f"(unpinned, not gated); block by block, expert choices pinned: "
        f"worst rel {lrel:.3g} ({where}, max abs {lab:.4g}; tol "
        f"{STEP_TOL}); {flipped} of {S * cfg.n_layers} (token, layer) "
        f"top-{m.top_k} expert sets differ between the two whole runs")
    _flash_launches(n, cfg.n_layers, f"{cfg.name} forward_train")
    if n["batched_gemm"] != want or not aux_rel <= 1e-3 or \
            not lrel <= STEP_TOL or not torch.isfinite(la).all():
        raise AssertionError(f"moe forward: batched_gemm launches "
                             f"{n['batched_gemm']} (want {want}), aux rel "
                             f"{aux_rel}, worst block {where} {lrel}")
    return {"S": S, "C": C, "auto_s": t_auto, "library_s": t_lib,
            "launch_counts": n, "batched_gemm_want": want,
            "aux": float(aux), "aux_library": float(auxp),
            "aux_rel_err": aux_rel, "rel_err": rel,
            "block_rel_err": lrel, "block_max_abs_err": lab,
            "worst_block": where, "expert_sets_flipped": flipped}


def phase_encdec_kernels(torch, launches):
    """The enc-dec slice's kernel shapes, each timed against its plain
    version, its library call and its bound: the IAAT kernel on
    seamless-m4t-large-v2's decode GEMMs at M = 4 (q/k/v/o 1024 x 1024,
    gate/up 1024 x 8192, down 8192 x 1024, the untied 1024 x 256256
    vocabulary head; library torch.matmul); flash non-causal at its
    cross attention at decode (B 4 x 16 heads x Sq 1 against Sk 1000 x D
    64) and its encoder (Sq = Sk = 1000), SDPA with no mask the library,
    and causal at olmo-1b's forward_train (B 2 x 16 x S 2048 x D 128);
    batched_gemm at moonshot's forward_train capacity.  ``launches``
    as :func:`phase_slice_kernels` takes it.  Returns rows per kernel."""
    from repro_torch import configs
    from repro_torch.models import layers
    sm = configs.get_config(ENCDEC_ARCH)
    olmo = configs.get_config("olmo-1b")
    moon = configs.get_config(MOE_ARCH)
    d, ff, V = sm.d_model, sm.d_ff, sm.vocab_padded
    H, Hkv, D = sm.n_heads_padded, sm.n_kv_heads_padded, sm.head_dim_
    C = layers._capacity(2048, moon.moe)
    rows = {"iaat_gemm": [
        _iaat_row(torch, ENCDEC_B, K, N, False, f"{ENCDEC_ARCH} {what}")
        for what, K, N in (("q/k/v/o", d, d), ("gate/up", d, ff),
                           ("down", ff, d), ("vocab head", d, V))]}
    rows["flash_attention"] = [
        _flash_row(torch, ENCDEC_B, H, Hkv, ENCDEC_SRC, D, None,
                   f"{ENCDEC_ARCH} cross attention at decode", Sq=1,
                   causal=False),
        _flash_row(torch, ENCDEC_B, H, Hkv, ENCDEC_SRC, D, None,
                   f"{ENCDEC_ARCH} encoder", causal=False),
        _flash_row(torch, 2, olmo.n_heads, olmo.n_kv_heads, 2048,
                   olmo.head_dim_, None, "olmo-1b forward_train")]
    rows["batched_gemm"] = [
        _batched_row(torch, moon, K, N, C, f"forward_train expert GEMM C {C}")
        for K, N in _grouped_decode_shapes(moon)]
    for name, rs in rows.items():
        for r in rs:
            r["main_path_launches"] = launches.get(name, {}).get(
                r["at"].split()[0])
    return rows


# --------------------------------------------------------------------------
# Training (train/ and launch/train.py): the IAAT kernel's forward inside
# autograd, its backward the adjoint GEMMs (torch.matmul); flash, grouped
# and SSD pinned to the library (Policy.kernels), as the reference pins
# them to XLA.
# --------------------------------------------------------------------------

#: the train phase: olmo-1b at full size, batch x seq 4 x 64 (M = 256:
#: cbrt(256 * 2048 * 2048) = 1024 <= HOPPER_CROSSOVER, so api.route sends
#: q/k/v/o to the IAAT kernel under auto, gate/up/down (1625) and the
#: vocabulary head to the library)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 64, 8
#: the restart phase's depth (of olmo-1b's 16 layers: 0.24 B parameters,
#: 2.85 GB a checkpoint of f32 master, m and v), steps, checkpoint
#: interval and the step its fault is injected at
RESTART_LAYERS, RESTART_STEPS, RESTART_EVERY, RESTART_FAULT = 2, 6, 2, 5
#: mamba2-780m's train phase: M = 128 sends in_proj (cbrt(128 * 1536 *
#: 6448) = 1079) and out_proj to the IAAT kernel under auto
SSM_TRAIN_B, SSM_TRAIN_S, SSM_TRAIN_STEPS = 2, 64, 3
#: one step from the same state and batch under the forced kernel against
#: the library, relative: loss, grad norm, the gradients (as the first
#: moment after one step, (1 - b1) times the clipped gradient, in norm:
#: ||m_kernel - m_library|| / ||m_library||) and the parameters' update
#: (||p_kernel - p_library|| / ||p_library - p0||).  f32: both take f32
#: products summed in other orders (the CPU parity tests measure 2.4e-7 /
#: 2.4e-7 / - / 3e-5 against JAX).  bf16: the library's bf16 GEMMs
#: (cuBLAS, its reduced-precision reductions allowed) and the kernel's f32
#: sums round to bf16 at other places.  Adam's first step moves every
#: element by lr times the sign of its gradient whatever its size, so the
#: update's difference is 2 sqrt(the share of elements whose gradient
#: sign differs): 0.3 allows 2.25 % of them, the near-zero gradients.
TRAIN_TOL = {"float32": (1e-5, 1e-5, 1e-4, 1e-4),
             "bfloat16": (2e-3, 3e-3, 5e-2, 0.3)}
#: IAAT launches a train step under remat "full": each checkpointed layer
#: runs its forward again in the backward pass, so olmo-1b's 64 q/k/v/o
#: launches (16 layers x 4) and mamba2-780m's 144 (48 layers x in_proj's
#: 2 regions and out_proj) are made twice.  The recompute stops once the
#: backward has every tensor it saved, but the IAAT kernel's autograd
#: Function saves its inputs after its forward has run, so out_proj, each
#: mamba layer's last GEMM, is launched again and its product dropped
TRAIN_IAAT_PER_STEP = 128
SSM_TRAIN_IAAT_PER_STEP = 288
#: the moe shards phase: dispatch groups and tokens; the sharded layer
#: against the one-shard calls, max abs difference over the largest
#: output: f32 sums of the same products in other orders, and bf16, where
#: the expert FFN's kernel and library round apart
MOE_SHARDS, MOE_SHARD_T = 8, 2048
MOE_SHARD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
#: the dry-run phase's cells and the reference's per-device argument
#: bytes of each (its own model.specs, make_rules, train_state_specs,
#: cache_shardings and jax.eval_shape on the abstract 16 x 16 and
#: 2 x 16 x 16 meshes, tests/test_torch_parallel.py's ref_argument_bytes;
#: the caches hold its 4-byte device pos)
DRYRUN_ARCHS = ("olmo-1b", "moonshot-v1-16b-a3b")
DRYRUN_SHAPES = ("train_4k", "decode_32k")
DRYRUN_BYTES = {
    ("olmo-1b", "train_4k", "single"): {"batch": 524288,
                                        "state": 127795204},
    ("olmo-1b", "decode_32k", "single"): {"batch": 32, "params": 21299200,
                                          "cache": 2147483652},
    ("moonshot-v1-16b-a3b", "train_4k", "single"): {"batch": 524288,
                                                    "state": 1791641092},
    ("moonshot-v1-16b-a3b", "decode_32k", "single"): {
        "batch": 32, "params": 298606848, "cache": 6442450948},
    ("olmo-1b", "train_4k", "multi"): {"batch": 262144,
                                       "state": 127795204},
    ("olmo-1b", "decode_32k", "multi"): {"batch": 16, "params": 21299200,
                                         "cache": 1073741828},
    ("moonshot-v1-16b-a3b", "train_4k", "multi"): {"batch": 262144,
                                                   "state": 1791641092},
    ("moonshot-v1-16b-a3b", "decode_32k", "multi"): {
        "batch": 16, "params": 298606848, "cache": 3221225476}}
#: the reference's device pos, which the port keeps on the host
POS_BYTES = 4
#: the anchor: olmo-1b's train step on the 1 x 1 mesh at B x S
ANCHOR_B, ANCHOR_S = 4, 64


def _train_args(*argv):
    from repro_torch.launch import train as train_mod
    return train_mod.build_args(["--log-every", "100", "--device", "cuda",
                                 *argv])


@contextlib.contextmanager
def _replaced(obj, name, value):
    """``obj.name`` is ``value`` for the body."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _train_run(torch, args, cfg=None):
    """``launch.train.run`` with the kernels' launches counted per step
    (each step counted from 0, read where the launcher records the step:
    ``train.loop.record_step``); ``cfg`` in place of the config of
    ``--arch`` (a depth cut).  The run must go through the launcher's
    host mesh: a one-rank NCCL group and a 1 x 1 ("data", "model") mesh,
    taken down when the run ends.  Returns (its result, the per-step
    counts)."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.train import loop as train_loop
    per_step, meshes = [], []
    record = train_loop.record_step
    host = mesh_mod.make_host_mesh

    def counted(step, m, dt):
        record(step, m, dt)
        per_step.append(dict(_counts(), step=step,
                             iaat_by_shape=dict(_BY_SHAPE)))
        _reset_counts()

    def host_mesh(device):
        mesh = host(device)
        meshes.append((dist.get_backend(), dist.get_world_size(),
                       tuple(mesh.shape), tuple(mesh.mesh_dim_names)))
        return mesh
    get = configs.get_config if cfg is None else (lambda arch: cfg)
    _reset_counts()
    with _replaced(train_loop, "record_step", counted), \
            _replaced(configs, "get_config", get), \
            _replaced(mesh_mod, "make_host_mesh", host_mesh):
        out = train_mod.run(args)
    if meshes != [("nccl", 1, (1, 1), ("data", "model"))] or \
            dist.is_initialized():
        raise AssertionError(f"train run: host meshes {meshes}, a group "
                             f"left behind: {dist.is_initialized()}")
    return out, per_step


def _check_history(out, per_step, args, what, want_iaat=1):
    """Every loss, grad norm and lr finite, the lr the schedule's, at
    least ``want_iaat`` IAAT launches in every step, no flash, grouped or
    SSD launch (pinned to the library)."""
    from repro_torch.train import optimizer as opt
    c = opt.OptConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                      decay_steps=max(args.steps, 10))
    for h, n in zip(out["history"], per_step):
        ok = all(math.isfinite(h[k]) for k in ("loss", "grad_norm", "lr"))
        if not ok or h["lr"] != opt.schedule(h["step"], c):
            raise AssertionError(f"{what} step {h['step']}: {h}")
        if n["iaat_gemm"] < want_iaat or n["flash_attention"] or \
                n["batched_gemm"] or n["ragged_gemm"] or n["ssd_scan"]:
            raise AssertionError(f"{what} step {h['step']}: launches {n}")


def _clone_state(st):
    from repro_torch.models.common import map_params

    def copy(m):
        return map_params(m, lambda _n, p: p.detach().clone())
    return {"params": copy(st["params"]),
            "opt": {k: copy(v) for k, v in st["opt"].items()},
            "step": st["step"]}


def _rel_norm(torch, got, want, start=None):
    """||got - want|| / ||want - start|| over every parameter of three
    modules (f64 sums; no ``start``: zeros)."""
    num = den = 0.0
    for (_, g), (_, w), s in zip(got.named_parameters(),
                                 want.named_parameters(),
                                 start.parameters() if start is not None
                                 else itertools.repeat(0.0)):
        num += float(((g.double() - w.double()) ** 2).sum())
        den += float(((w.double() - s) ** 2).sum())
    return (num / den) ** 0.5


def _step_parts(torch, model, tc, pol, st, batch):
    """One train step (``make_train_step``'s, ``accum_steps`` 1) on
    ``st``, which it advances, cut at its three parts, each timed on the
    host clock to a synchronize: the working copy's cast, forward and
    backward (the loss and ``autograd.grad``), AdamW; seconds of each."""
    from repro_torch.train import loop as TL
    from repro_torch.train import optimizer as opt
    loss_fn = TL.make_loss_fn(model, tc, pol)
    torch.cuda.synchronize()
    t = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        t.append(time.perf_counter())
    pc = TL.cast_params_for_compute(st["params"], model.cfg)
    mark()
    names, leaves = zip(*pc.named_parameters())
    loss, _ = loss_fn(pc, batch)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    mark()
    st["params"], st["opt"], _ = opt.adamw_update(
        st["params"], grads, st["opt"], st["step"], tc.opt)
    st["step"] += 1
    mark()
    return {k: b - a for k, a, b in zip(("cast", "forward_backward",
                                         "adamw"), t, t[1:])}


def _one_step_pair(torch, cfg, dtype):
    """One train step of olmo-1b (``cfg``) in ``dtype`` from one seeded
    state and batch under ``auto``, the forced kernel and the library
    (each after an uncounted warm-up step on a copy): step seconds, IAAT
    launches, and kernel against library."""
    import dataclasses
    from repro_torch import api
    from repro_torch.models import registry
    from repro_torch.train import data as data_mod
    from repro_torch.train import loop as TL
    from repro_torch.train import optimizer as opt
    cfg = dataclasses.replace(cfg, dtype=dtype)
    model = registry.build(cfg)
    st0 = TL.init_train_state(
        model, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = data_mod.to_device(data_mod.SyntheticTokens(
        cfg.vocab, TRAIN_S, TRAIN_B, seed=0).batch(0), "cuda")
    tc = TL.TrainConfig(opt=opt.OptConfig(peak_lr=3e-4, warmup_steps=20,
                                          decay_steps=TRAIN_STEPS))
    res = {}
    for name, pol in (("auto", api.Policy(backend="auto")),
                      ("kernel", api.Policy(backend="kernel")),
                      ("library", api.named_policy("library"))):
        step = TL.make_train_step(model, tc, pol.replace(kernels="library"))
        step(_clone_state(st0), batch)                      # warm-up
        st = _clone_state(st0)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        st, m = step(st, batch)
        m = {k: float(v) for k, v in m.items()}
        dt = time.perf_counter() - t0
        n = _counts()
        res[name] = {"seconds": dt, "iaat_launches": n["iaat_gemm"],
                     "iaat_split": n["iaat_split"], **m}
        if name != "auto":
            res[name]["state"] = st
        del st
        _free(torch)
    k, lib = res["kernel"], res["library"]
    loss_rel = abs(k["loss"] - lib["loss"]) / abs(lib["loss"])
    gn_rel = abs(k["grad_norm"] - lib["grad_norm"]) / lib["grad_norm"]
    g_rel = _rel_norm(torch, k["state"]["opt"]["m"],
                      lib["state"]["opt"]["m"])
    upd = _rel_norm(torch, k["state"]["params"], lib["state"]["params"],
                    st0["params"])
    tl, tg, tgr, tu = TRAIN_TOL[dtype]
    out = {n: {key: v for key, v in r.items() if key != "state"}
           for n, r in res.items()}
    out.update(loss_rel=loss_rel, grad_norm_rel=gn_rel, grad_rel=g_rel,
               update_rel=upd)
    log(f"train step {cfg.name} {dtype} B{TRAIN_B} x S{TRAIN_S}: "
        + "; ".join(f"{n} {r['seconds'] * 1e3:.2f} ms, loss "
                    f"{r['loss']:.6f}, grad norm "
                    f"{r['grad_norm']:.6f}, IAAT {r['iaat_launches']} "
                    f"launches ({r['iaat_split']} split)"
                    for n, r in out.items() if isinstance(r, dict))
        + f"; kernel vs library: loss {loss_rel:.3g} (tol {tl}), grad norm "
        f"{gn_rel:.3g} (tol {tg}), gradients {g_rel:.3g} (tol {tgr}), "
        f"update {upd:.3g} (tol {tu})")
    if not (loss_rel <= tl and gn_rel <= tg and g_rel <= tgr
            and upd <= tu) or \
            out["kernel"]["iaat_launches"] < 1 or \
            out["auto"]["iaat_launches"] < 1 or \
            out["library"]["iaat_launches"]:
        raise AssertionError(f"train step {dtype}: {out}")
    return out


def _train_gemm_equality(torch, cfg):
    """The IAAT kernel (forced) against ``torch.matmul`` at the train
    step's GEMM shapes (M = 256: q/k/v/o, gate/up, down, the tied
    vocabulary head), f32 and bf16: the share of output elements equal to
    the bit and the largest difference."""
    from repro_torch import api
    kern = api.Policy(backend="kernel")
    g = torch.Generator(device="cuda").manual_seed(47)
    M, d, ff = TRAIN_B * TRAIN_S, cfg.d_model, cfg.d_ff
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        for K, N in ((d, d), (d, ff), (ff, d), (d, cfg.vocab_padded)):
            x = torch.randn(M, K, generator=g, device="cuda").to(dt)
            w = (torch.randn(K, N, generator=g, device="cuda")
                 / math.sqrt(K)).to(dt)
            a, b = api.matmul(x, w, policy=kern), torch.matmul(x, w)
            out[f"{str(dt)[6:]} {M}x{K}x{N}"] = (
                float((a == b).float().mean()),
                float((a.double() - b.double()).abs().max()))
    log("train GEMMs, IAAT kernel against torch.matmul (share equal to the "
        "bit, max abs diff): " + ", ".join(f"{k} {v[0]:.6f} {v[1]:.3g}"
                                           for k, v in out.items()))
    return out


def phase_train(torch, cfg):
    """olmo-1b at full width and depth through ``launch.train.run`` for
    TRAIN_STEPS steps under ``auto`` (bf16 compute, f32 master) on the
    host mesh with remat "full": TRAIN_IAAT_PER_STEP IAAT launches in
    every step (the forward's 64 and the recompute's 64), no other
    kernel's, finite metrics, the schedule's lr; then one step under the
    forced kernel against the library, in bf16 and with the weights
    widened to f32."""
    from repro_torch import api
    prev = api.current_policy()
    args = _train_args("--arch", "olmo-1b", "--steps", str(TRAIN_STEPS),
                       "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
                       "--backend", "auto")
    out, per_step = _train_run(torch, args)
    _check_history(out, per_step, args, "train")
    secs = [h["seconds"] for h in out["history"]]
    iaat = [n["iaat_gemm"] for n in per_step]
    if set(iaat) != {TRAIN_IAAT_PER_STEP}:
        raise AssertionError(f"train: IAAT launches a step {iaat}, want "
                             f"{TRAIN_IAAT_PER_STEP}")
    log(f"train {cfg.name} auto B{TRAIN_B} x S{TRAIN_S}: losses "
        f"{[round(h['loss'], 5) for h in out['history']]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in out['history']]}; step s "
        f"{[round(s, 4) for s in secs]}; IAAT launches a step {iaat} "
        f"({[n['iaat_split'] for n in per_step]} split, "
        f"{[n['iaat_ring'] for n in per_step]} ring)")
    pair = {dt: _one_step_pair(torch, cfg, dt)
            for dt in ("bfloat16", "float32")}
    api.install(prev)
    return {"history": out["history"], "iaat_launches": iaat,
            "launches": sum(iaat), "step_s_median": sorted(secs[1:])[
                len(secs[1:]) // 2], "one_step": pair,
            "gemm_equality": _train_gemm_equality(torch, cfg)}


def _final_leaves(d):
    """{leaf file: array} of the last checkpoint in ``d`` (the final
    state ``launch.train.run`` saves at ``--steps``)."""
    import numpy as np
    from repro_torch.train import checkpoint as ckpt_mod
    ck = ckpt_mod.Checkpointer(d)
    step = pathlib.Path(d) / f"step_{ck.latest_step():08d}"
    return {f.name: np.load(f) for f in sorted(step.glob("*.npy"))}


def _leaf_diff(got, want):
    """The largest |got - want| over every element of every leaf (inf
    where the leaf names or shapes differ)."""
    import numpy as np
    if set(got) != set(want):
        return math.inf
    out = 0.0
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape:
            return math.inf
        if w.size:
            out = max(out, float(np.abs(g.astype(np.float64)
                                        - w.astype(np.float64)).max()))
    return out


def phase_train_restart(torch, cfg):
    """olmo-1b at full width and RESTART_LAYERS of its 16 layers through
    ``launch.train.run``: twice uninterrupted (the card's run-to-run
    spread: the losses and the final states, params, m and v, leaf for
    leaf), then with asynchronous checkpoints every RESTART_EVERY steps
    and a fault at RESTART_FAULT, restored from the last checkpoint.  The
    restarted run's losses and final state may differ from the first
    uninterrupted run's by no more than the two uninterrupted runs differ
    (on the H100 they are equal to the bit, so the restart must be too).
    Every run saves its final state; the checkpoints go to temporary
    directories under build/, removed afterwards."""
    import dataclasses
    from repro_torch import api
    prev = api.current_policy()
    cut = dataclasses.replace(cfg, n_layers=RESTART_LAYERS)
    base = ("--arch", "olmo-1b", "--steps", str(RESTART_STEPS), "--batch",
            str(TRAIN_B), "--seq", str(TRAIN_S), "--backend", "auto")
    (ROOT / "build").mkdir(exist_ok=True)
    runs, finals = [], []
    for _ in range(2):
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            runs.append(_train_run(torch, _train_args(*base, "--ckpt-dir", d),
                                   cut))
            finals.append(_final_leaves(d))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        t0 = time.perf_counter()
        args = _train_args(*base, "--ckpt-dir", d, "--ckpt-every",
                           str(RESTART_EVERY), "--inject-fault-at",
                           str(RESTART_FAULT))
        out, per_step = _train_run(torch, args, cut)
        t_fault = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in
                         pathlib.Path(d).rglob("*.npy"))
        restarted = _final_leaves(d)
    for o, n in runs + [(out, per_step)]:
        _check_history(o, n, args, "train restart")
    a, b = runs[0][0], runs[1][0]

    def loss_diff(x):
        # the last run of each step (a restart runs steps again)
        got = {h["step"]: h["loss"] for h in x["history"]}
        return max(abs(got[h["step"]] - h["loss"]) / abs(h["loss"])
                   for h in a["history"])
    spread, rel = loss_diff(b), loss_diff(out)
    state_spread = _leaf_diff(finals[1], finals[0])
    state_diff = _leaf_diff(restarted, finals[0])
    steps = [h["step"] for h in out["history"]]
    want = list(range(RESTART_FAULT)) + list(range(
        RESTART_FAULT - RESTART_FAULT % RESTART_EVERY, RESTART_STEPS))
    log(f"train restart {cut.name} ({RESTART_LAYERS} layers): steps run "
        f"{steps}; final loss {out['loss']:.7f} against {a['loss']:.7f} "
        f"uninterrupted; losses apart by {rel:.3g} at most (rel; two "
        f"uninterrupted runs {spread:.3g}), final state (params, m, v; "
        f"{len(restarted)} leaves) by {state_diff:.3g} at most (two "
        f"uninterrupted runs {state_spread:.3g}); fault run {t_fault:.1f} "
        f"s, {ckpt_bytes / 1e9:.2f} GB of checkpoints kept")
    if steps != want or out["final_step"] != RESTART_STEPS or \
            not rel <= spread or not state_diff <= state_spread:
        raise AssertionError(f"train restart: steps {steps} (want {want}),"
                             f" loss {rel} (spread {spread}), state "
                             f"{state_diff} (spread {state_spread})")
    api.install(prev)
    return {"layers": RESTART_LAYERS, "steps": steps, "loss": out["loss"],
            "uninterrupted_loss": a["loss"], "rel": rel, "spread": spread,
            "state_diff": state_diff, "state_spread": state_spread,
            "fault_run_s": t_fault, "ckpt_bytes_kept": ckpt_bytes,
            "history": out["history"]}


def ssm_train_shapes(scfg):
    """mamba2's two projections in the ssm train phase, (M, K, N): in_proj
    and out_proj."""
    s, M = scfg.ssm, SSM_TRAIN_B * SSM_TRAIN_S
    return {"in_proj": (M, scfg.d_model, 2 * scfg.d_inner + 2 * s.d_state
                        + scfg.ssm_heads),
            "out_proj": (M, scfg.d_inner, scfg.d_model)}


def phase_ssm_train(torch, scfg):
    """mamba2-780m at full width and depth through ``launch.train.run``
    for SSM_TRAIN_STEPS steps under ``auto`` on the host mesh with remat
    "full": SSM_TRAIN_IAAT_PER_STEP IAAT launches in every step (the
    forward's 144 and the recompute's 144), at in_proj and
    out_proj in every step and nowhere else (counted by shape,
    ``_count_by_shape``), no SSD launch (the scan runs ``ref.ref_ssd``
    under autograd).  Returns the launches by projection for
    phase_train_kernels, which holds the kernel at those shapes."""
    from repro_torch import api
    prev = api.current_policy()
    args = _train_args("--arch", SSM_ARCH, "--steps", str(SSM_TRAIN_STEPS),
                       "--batch", str(SSM_TRAIN_B), "--seq",
                       str(SSM_TRAIN_S), "--backend", "auto")
    out, per_step = _train_run(torch, args)
    _check_history(out, per_step, args, "ssm train")
    iaat = [n["iaat_gemm"] for n in per_step]
    if set(iaat) != {SSM_TRAIN_IAAT_PER_STEP}:
        raise AssertionError(f"ssm train: IAAT launches a step {iaat}, want"
                             f" {SSM_TRAIN_IAAT_PER_STEP}")
    shapes = {"x".join(map(str, mkn)): name
              for name, mkn in ssm_train_shapes(scfg).items()}
    by_proj = dict.fromkeys(shapes.values(), 0)
    for n in per_step:
        got = n["iaat_by_shape"]
        if set(got) != set(shapes) or sum(got.values()) != n["iaat_gemm"]:
            raise AssertionError(f"ssm train step {n['step']}: IAAT "
                                 f"launches by shape {got}, want each of "
                                 f"{sorted(shapes)} and no other")
        for k, v in got.items():
            by_proj[shapes[k]] += v
    log(f"ssm train {scfg.name} auto B{SSM_TRAIN_B} x S{SSM_TRAIN_S}: "
        f"losses {[round(h['loss'], 5) for h in out['history']]}, step s "
        f"{[round(h['seconds'], 4) for h in out['history']]}, IAAT "
        f"launches a step {iaat} (over the run: " + ", ".join(
            f"{p} {by_proj[p]}" for p in by_proj) + "), SSD launches 0")
    api.install(prev)
    return {"history": out["history"], "iaat_launches": iaat,
            "iaat_by_proj": by_proj}


def phase_train_profile(torch, cfg):
    """One olmo-1b train step under ``auto`` (bf16, the train phase's
    batch), warm: its wall time (the median of 3, to a synchronize), the
    median of 3 more cut at their parts (``_step_parts``, on the same
    one state: their sum is a step's time with two more synchronizes)
    and, from a torch.profiler trace of one more, its device kernels'
    time by group (the IAAT kernel, the library's GEMMs, the rest) and
    count; the device's idle share is 1 - device / wall.  Run after every
    other traced phase: a trace of this many kernels can leave later
    traces of the process empty."""
    from repro_torch import api
    from repro_torch.models import registry
    from repro_torch.train import data as data_mod
    from repro_torch.train import loop as TL
    from torch.profiler import ProfilerActivity, profile
    model = registry.build(cfg)
    st = TL.init_train_state(
        model, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = data_mod.to_device(data_mod.SyntheticTokens(
        cfg.vocab, TRAIN_S, TRAIN_B, seed=0).batch(0), "cuda")
    tc = TL.TrainConfig()
    pol = api.Policy(backend="auto", kernels="library")
    step = TL.make_train_step(model, tc, pol)
    walls = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step(st, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        if i >= 2:
            walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    cuts = [_step_parts(torch, model, tc, pol, st, batch) for _ in range(3)]
    parts = {k: sorted(c[k] for c in cuts)[1] for k in cuts[0]}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st, m = step(st, batch)
        float(m["loss"])
        torch.cuda.synchronize()
    groups = {"iaat_gemm": 0.0, "library_gemm": 0.0, "other": 0.0}
    n = 0
    top = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        t = getattr(e, "self_device_time_total", 0.0) / 1e3
        if t <= 0:
            continue
        n += e.count
        key = e.key.lower()
        grp = "iaat_gemm" if "iaat_gemm" in key else "library_gemm" if any(
            w in key for w in ("gemm", "xmma", "cutlass")) else "other"
        groups[grp] += t
        top.append((t, e.count, e.key[:70]))
    dev = sum(groups.values())
    if not n or dev <= 0:
        raise AssertionError("train profile: the trace holds no device "
                             "kernel")
    top = sorted(top, reverse=True)[:8]
    log(f"train profile {cfg.name} auto B{TRAIN_B} x S{TRAIN_S}: wall "
        f"{wall * 1e3:.2f} ms (median of 3); parts (median of 3): "
        + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in parts.items())
        + f", sum {sum(parts.values()) * 1e3:.2f} ms; device {dev:.2f} ms "
        f"over {n} "
        f"kernels (idle {1 - dev / (wall * 1e3):.3f}): " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in groups.items()) + "; top: "
        + "; ".join(f"{k} {t:.2f} ms x{c}" for t, c, k in top))
    del st
    _free(torch)
    return {"wall_ms": wall * 1e3, "parts_ms": {k: v * 1e3 for k, v in
                                                parts.items()},
            "device_ms": dev, "kernels": n,
            "idle_share": 1 - dev / (wall * 1e3), "groups_ms": groups,
            "top": top}


def phase_train_kernels(torch, cfg, launches, scfg, ssm_launches):
    """The IAAT kernel at the train phase's q/k/v/o shape (M = B x S =
    256, d x d) and at the ssm train phase's in_proj and out_proj (M 128),
    bf16, each held against its plain version and timed against it, the
    library and the bound, for ``slice_shapes``; ``launches`` the train
    phase's, ``ssm_launches`` the ssm train phase's by projection."""
    row = _iaat_row(torch, TRAIN_B * TRAIN_S, cfg.d_model, cfg.d_model,
                    False, "olmo-1b train q/k/v/o")
    row["main_path_launches"] = launches
    rows = [row]
    for name, (M, K, N) in ssm_train_shapes(scfg).items():
        r = _iaat_row(torch, M, K, N, False, f"{scfg.name} train {name}")
        r["main_path_launches"] = ssm_launches[name]
        rows.append(r)
    return {"iaat_gemm": rows}


def phase_moe_shards(torch, cfg, params):
    """moonshot's MoE layer 0 (its weights as "moe serve" loaded them) on
    MOE_SHARD_T tokens under the per-data-shard branch (``_moe_shards`` =
    MOE_SHARDS in the activation context, on a 1 x 1 stand-in mesh),
    against MOE_SHARDS one-shard calls on the token slices with their
    expert choices pinned to the sharded run's (the router's matmul at
    another M can round a near-tie apart), under ``auto``: bf16 as served,
    then the layer's weights widened to f32; each within MOE_SHARD_TOL of
    the largest output, the aux the slices' mean.  Then forward_train of
    1 x MOE_SHARD_T tokens under ``auto`` at MOE_SHARDS groups and at 1:
    one flash launch a layer each, finite logits."""
    from repro_torch import api
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import layers, lm
    from repro_torch.parallel.ctx import activation_sharding
    auto = api.Policy(backend="auto")
    one = mesh_mod.mesh_shape((1, 1), ("data", "model"))

    def shards(G):
        return activation_sharding(one, {"_moe_shards": G,
                                         "moe_group": None})
    G, T, d = MOE_SHARDS, MOE_SHARD_T, cfg.d_model
    g = torch.Generator(device="cuda").manual_seed(48)
    x0 = torch.randn(1, T, d, generator=g, device="cuda")
    blk = params.blocks[0].moe
    out = {}
    with torch.no_grad():
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            p = blk if dt == "bfloat16" else lm.MoE(*(
                getattr(blk, k).float() for k in lm.MOE_W))
            x = x0.to(dtype)
            with shards(G), _ExpertChoices(layers) as ch:
                y, aux = layers.moe(p, x, auto, cfg)
            idx = ch.seen[0]
            part = T // G
            pins = [idx[i * part:(i + 1) * part] for i in range(G)]
            ys, auxs = [], []
            with _ExpertChoices(layers, pinned=pins):
                for i in range(G):
                    yi, ai = layers.moe(p, x[:, i * part:(i + 1) * part],
                                        auto, cfg)
                    ys.append(yi)
                    auxs.append(ai)
            want = torch.cat(ys, 1)
            ab, rel = _rel_err(y, want)
            aux_want = torch.stack(auxs).mean()
            aux_rel = abs(float(aux) - float(aux_want)) / abs(float(aux_want))
            out[dt] = {"max_abs": ab, "rel": rel, "aux_rel": aux_rel}
            if not (rel <= MOE_SHARD_TOL[dt] and aux_rel <= 1e-5) or \
                    tuple(idx.shape) != (T, cfg.moe.top_k):
                raise AssertionError(f"moe shards {dt}: {out[dt]}")
        toks = torch.randint(0, cfg.vocab, (1, T), generator=g,
                             device="cuda")
        runs = {}
        for groups in (G, 1):
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with shards(groups):
                logits, aux = lm.forward_train(params, cfg, auto, toks)
            torch.cuda.synchronize()
            n = _counts()
            runs[groups] = {"seconds": time.perf_counter() - t0,
                            "flash": n["flash_attention"],
                            "batched_gemm": n["batched_gemm"],
                            "iaat": n["iaat_gemm"], "aux": float(aux),
                            "finite": bool(torch.isfinite(logits).all())}
            if runs[groups]["flash"] != cfg.n_layers or \
                    not runs[groups]["finite"]:
                raise AssertionError(f"moe shards forward G {groups}: "
                                     f"{runs[groups]}")
            del logits
    log(f"moe shards {cfg.name}: layer 0 on {T} tokens in {G} groups "
        f"against {G} one-shard calls (choices pinned): " + "; ".join(
            f"{k} max abs {v['max_abs']:.3g}, rel {v['rel']:.3g} (tol "
            f"{MOE_SHARD_TOL[k]}), aux rel {v['aux_rel']:.3g}"
            for k, v in out.items()) + "; forward_train 1x" + str(T) + ": "
        + "; ".join(f"G {k}: {v['seconds']:.3f} s, flash {v['flash']}, "
                    f"batched_gemm {v['batched_gemm']}, IAAT {v['iaat']}, "
                    f"aux {v['aux']:.6g}" for k, v in runs.items()))
    return {"layer": out, "forward": runs}


def start_dryrun():
    """The dry-run CLI for the phase's cells in a subprocess that sees no
    card (CUDA_VISIBLE_DEVICES empty): it runs on the CPU's meta device
    while the card phases run.  Returns the process; its log and JSON go
    to chiprun_out/."""
    import os
    OUT_DIR.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    logf = open(OUT_DIR / "dryrun.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         ",".join(DRYRUN_ARCHS), "--shape", ",".join(DRYRUN_SHAPES),
         "--mesh", "both", "--out", str(OUT_DIR / "dryrun.json")],
        cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT)
    proc.log_file = logf
    return proc


def phase_dryrun(torch, cfg, proc, timeout=900):
    """The dry run's cells (``start_dryrun``): every one ok, its per-device
    argument bytes DRYRUN_BYTES's (the cache POS_BYTES short), its
    seconds; then the anchor, olmo-1b (``cfg``) at ANCHOR_B x ANCHOR_S on
    the 1 x 1 mesh under ``library``: the dry run's train-state bytes
    against the change of torch.cuda.memory_allocated() across
    init_train_state (within 1 %), the step counter's matmul FLOPs of one
    step on meta against the same counter around a real step on the card
    (equal), and the real step's time (median of 3, warm) beside the
    roofline's step_s."""
    from repro_torch import api
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, mesh as mesh_mod
    from repro_torch.launch.step_analyzer import StepCounter
    from repro_torch.models import registry
    from repro_torch.parallel import rules as R
    from repro_torch.parallel.ctx import activation_axes, activation_sharding
    from repro_torch.train import loop as TL
    t0 = time.perf_counter()
    rc = proc.wait(timeout=timeout)
    proc.log_file.close()
    waited = time.perf_counter() - t0
    res = json.loads((OUT_DIR / "dryrun.json").read_text())
    cells = {}
    for (arch, shape, mesh), want in DRYRUN_BYTES.items():
        rec = res.get(f"{arch}|{shape}|{mesh}", {})
        got = rec.get("memory_analysis", {}).get("arguments")
        if rec.get("status") != "ok" or got is None:
            raise AssertionError(f"dryrun {arch} {shape} {mesh}: "
                                 f"{rec.get('status')} "
                                 f"{rec.get('error', '')}")
        exp = dict(want)
        if "cache" in exp:
            exp["cache"] -= POS_BYTES
        if got != exp:
            raise AssertionError(f"dryrun {arch} {shape} {mesh}: argument "
                                 f"bytes {got}, want {exp}")
        cells[f"{arch}|{shape}|{mesh}"] = {
            "count_s": rec["count_s"], "arguments": got,
            "flops_per_dev": rec["roofline"]["flops"],
            "hbm_bytes_per_dev": rec["roofline"]["hbm_bytes"],
            "step_s": rec["roofline"]["step_s"],
            "dominant": rec["roofline"]["dominant"]}
    if rc != 0 or len(cells) != len(DRYRUN_BYTES):
        raise AssertionError(f"dryrun: exit {rc}, cells {sorted(cells)}")
    log(f"dryrun: {len(cells)} cells ok on the meta device (waited "
        f"{waited:.1f} s for the subprocess): " + "; ".join(
            f"{k} {v['count_s']} s, args {v['arguments']}, "
            f"flops/dev {v['flops_per_dev']:.4g}, step_s "
            f"{v['step_s']:.4g} ({v['dominant']})"
            for k, v in cells.items()))
    # the anchor
    lib = api.named_policy("library")
    one = mesh_mod.mesh_shape((1, 1), ("data", "model"))
    shape = ShapeConfig("anchor", ANCHOR_S, ANCHOR_B, "train")
    rec = dryrun.run_cell("olmo-1b", "anchor", False, accum=1, mesh=one,
                          cfg=cfg, shape=shape)
    state_b = rec["memory_analysis"]["arguments"]["state"]
    model = registry.build(cfg)
    _free(torch)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    st = TL.init_train_state(
        model, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated() - m0
    state_rel = abs(state_b - alloc) / alloc
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (ANCHOR_B, ANCHOR_S),
                              generator=g, device="cuda",
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    step = TL.make_train_step(model, TL.TrainConfig(), lib)
    act = activation_axes(cfg, one, R.batch_spec(one, ANCHOR_B))
    walls = []
    with api.using(lib), activation_sharding(one, act):
        with StepCounter() as card:
            st, m = step(st, batch)
            float(m["loss"])
        for _ in range(4):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st, m = step(st, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
    wall = sorted(walls[1:])[1]
    meta_flops = rec["analyzer"]["flops"]
    out = {"cells": cells, "waited_s": waited,
           "anchor": {"state_bytes_dryrun": state_b,
                      "state_bytes_allocated": alloc,
                      "state_rel": state_rel, "flops_meta": meta_flops,
                      "flops_card": card.flops, "dots_meta":
                      rec["analyzer"]["dots"], "dots_card": card.dots,
                      "bytes_meta": rec["analyzer"]["bytes"],
                      "bytes_card": card.bytes, "step_s_card": wall,
                      "roofline": rec["roofline"]}}
    log(f"dryrun anchor {cfg.name} B{ANCHOR_B} x S{ANCHOR_S} (library, 1x1 "
        f"mesh): train state {state_b} B (dry run) against {alloc} B "
        f"allocated ({state_rel:.3g} rel, tol 0.01); step matmul FLOPs "
        f"{meta_flops} on meta, {card.flops} on the card ({card.dots} "
        f"matmuls); operand + output bytes {rec['analyzer']['bytes']} meta,"
        f" {card.bytes} card; step {wall * 1e3:.2f} ms on the card against "
        f"the roofline's {rec['roofline']['step_s'] * 1e3:.3f} ms "
        f"({rec['roofline']['dominant']}-bound)")
    del st
    _free(torch)
    if not state_rel <= 0.01 or meta_flops != card.flops or \
            card.flops <= 0:
        raise AssertionError(f"dryrun anchor: {out['anchor']}")
    return out


def _mixtral_cfg():
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(MIXTRAL_ARCH),
                               n_layers=MIXTRAL_LAYERS)


def main():
    """Every phase, in order."""
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
    _count_vocab_head()
    _count_by_shape()
    cfg = configs.get_config("olmo-1b")
    mcfg = configs.get_config(MOE_ARCH)
    scfg = configs.get_config(SSM_ARCH)
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

    dry = None
    try:
        report["card"] = timed("card", phase_card)
        report["flash_build"] = timed("build", phase_build)
        dry = start_dryrun()
        max_err = timed("check", phase_check, torch)
        report["concurrent_split"] = timed(
            "concurrent split", phase_concurrent_split, torch, mcfg)
        report["grid_check"] = timed("grid check", phase_grid_check, torch)
        report["pack"] = timed("pack baseline", phase_pack, torch)
        report["flash_check"] = timed("flash check", phase_flash_check,
                                      torch)
        report["ssd_check"] = timed("ssd check", phase_ssd_check, torch,
                                    scfg)
        report["serve"], params = timed("serve", phase_serve, torch,
                                        "olmo-1b", cfg, 6, 16, ["iaat_gemm"])
        report["step"] = timed("step", phase_step, torch, cfg, params)
        report["wave_serve"] = timed("wave serve", phase_wave_serve, torch,
                                     cfg, params)
        report["wave_step"] = timed("wave step", phase_wave_step, torch,
                                    cfg, params)
        report["online_serve"] = timed("online serve", phase_online_serve,
                                       torch, params, report["card"])
        report["trace"] = timed("trace", phase_trace, torch,
                                report["online_serve"], report["card"])
        report["forward"] = timed("forward", phase_forward, torch, cfg,
                                  params)
        del params
        torch.cuda.empty_cache()
        report["train"] = timed("train", phase_train, torch, cfg)
        report["train_restart"] = timed("train restart",
                                        phase_train_restart, torch, cfg)
        report["ssm_train"] = timed("ssm train", phase_ssm_train, torch,
                                    scfg)
        _free(torch)
        grouped_err, ragged_launches = timed("grouped check",
                                             phase_grouped_check, torch, mcfg)
        report["moe_serve"], params = timed(
            "moe serve", phase_serve, torch, MOE_ARCH, mcfg, 5, 8,
            ["batched_gemm", "iaat_gemm"])
        report["online_grouped"] = timed("online grouped",
                                         phase_online_grouped, torch,
                                         report["card"])
        report["moe_step"] = timed("moe step", phase_step, torch, mcfg,
                                   params)
        report["moe_forward"] = timed("moe forward", phase_moe_forward,
                                      torch, mcfg, params)
        report["moe_shards"] = timed("moe shards", phase_moe_shards, torch,
                                     mcfg, params)
        del params
        torch.cuda.empty_cache()
        report["ssm_serve"], params = timed("ssm serve", phase_ssm_serve,
                                            torch, scfg)
        report["ssm_forward"] = timed("ssm forward", phase_ssm_forward,
                                      torch, scfg, params)
        del params
        torch.cuda.empty_cache()
        report["gemma3"] = timed("gemma3", phase_gemma3, torch,
                                 configs.get_config(GEMMA_ARCH))
        report["dense"] = timed("dense", lambda: {
            a: phase_paged(torch, a, configs.get_config(a))
            for a in DENSE_ARCHS})
        report["mixtral"] = timed("mixtral", phase_paged, torch,
                                  MIXTRAL_ARCH, _mixtral_cfg(), 5, 8,
                                  ("batched_gemm", "iaat_gemm"))
        report["zamba2"] = timed("zamba2", phase_zamba2, torch,
                                 configs.get_config(ZAMBA_ARCH))
        report["vlm"] = timed("vlm", phase_vlm, torch,
                              configs.get_config(VLM_ARCH))
        report["encdec"] = timed("encdec", phase_encdec, torch,
                                 configs.get_config(ENCDEC_ARCH))
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
        ssd_entry, ssd_rows = timed(
            "ssd kernels", phase_ssd_kernels, torch, scfg,
            report["ssm_forward"]["launches"])
        gem, zam = report["gemma3"], report["zamba2"]["forward"]
        slice_rows = timed("slice kernels", phase_slice_kernels, torch, {
            "iaat_gemm": {
                GEMMA_ARCH: gem["serve"]["auto"]["launch_counts"][
                    "iaat_vocab_head"],
                "glm4-9b": report["dense"]["glm4-9b"]["serve"]["auto"][
                    "launches"]},
            "flash_attention": {
                GEMMA_ARCH: gem["wave"]["auto"]["launch_counts"][
                    "flash_attention"],
                ZAMBA_ARCH: zam["launch_counts"]["flash_attention"]},
            "batched_gemm": {
                MIXTRAL_ARCH: report["mixtral"]["serve"]["auto"][
                    "launch_counts"]["batched_gemm"]},
            "ssd_scan": {ZAMBA_ARCH: zam["launch_counts"]["ssd_scan"]}})
        sm = report["encdec"]["greedy"][f"auto B{ENCDEC_B}"]
        encdec_rows = timed("encdec kernels", phase_encdec_kernels, torch, {
            "iaat_gemm": {ENCDEC_ARCH: sm["prefill_launch_counts"][
                "iaat_gemm"] + sum(sm["decode_step_iaat"])},
            "flash_attention": {
                ENCDEC_ARCH: sm["prefill_launch_counts"]["flash_attention"]
                + sum(sm["decode_step_flash"]),
                "olmo-1b": report["forward"]["launch_counts"][
                    "flash_attention"]},
            "batched_gemm": {MOE_ARCH: report["moe_forward"][
                "launch_counts"]["batched_gemm"]}})
        train_rows = timed("train kernels", phase_train_kernels, torch, cfg,
                           report["train"]["launches"], scfg,
                           report["ssm_train"]["iaat_by_proj"])
        # before the tune: after its sweep, torch.profiler traces drop the
        # first kernels of a trace (two of ten or of fifty, on the H100)
        grid = report["grid_check"]
        cx, cx_rows = timed(
            "complex kernels", phase_complex_kernels, torch,
            grid["launches"]["cx_gemm"],
            max(grid["max_abs_err"]["C"], grid["max_abs_err"]["Z"]))
        report["encdec_step"] = timed("encdec step", phase_encdec_step,
                                      torch, configs.get_config(ENCDEC_ARCH))
        report["train_profile"] = timed("train profile",
                                        phase_train_profile, torch, cfg)
        report["dryrun"] = timed("dryrun", phase_dryrun, torch, cfg, dry)
        report["tune"] = timed("tune", phase_tune, torch, mcfg)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        if dry is not None and dry.poll() is None:
            dry.kill()
            dry.wait()
    report["kernels"] = [entry] + grouped + [flash, cx, ssd_entry]
    for e in report["kernels"]:
        # the same kernel at the later slices' shapes (decoder-only
        # families, then enc-dec and forward_train, then training)
        more = slice_rows.get(e["name"], []) + encdec_rows.get(
            e["name"], []) + train_rows.get(e["name"], [])
        if more:
            e["slice_shapes"] = more
    report["shapes"] = rows + grouped_rows + flash_rows + cx_rows + ssd_rows \
        + [r for rs in slice_rows.values() for r in rs] \
        + [r for rs in encdec_rows.values() for r in rs] \
        + [r for rs in train_rows.values() for r in rs]
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
