"""The paged-attention kernel against the plain path, and which calls take it.

On the card (tests marked ``card``, which skip without CUDA) the kernel
(``kernels/paged_attention.py``) runs on the same pools, tables and
queries as ``paged_attention_plain``: decode rows and prefill chunks
with and without replay rows, GQA groups of 1, 4 and 8 heads, head dims
64, 128 and 256, gemma3's 512-key window, slot lengths around a block's
edges up to a full 1152-key table, null-block padding and inactive
slots, and tables scored in tiles (a 65536-key table, and the same cases
under a shared-memory limit small enough to tile them).  Both sides take f32 sums of the same exact bf16 products in two
orders of summation, so their scores differ by f32 rounding; a
probability then rounds to bf16 on either side of a tie at most one
bf16 step apart (2^-7 of it), and the output rounds to bf16 once.  So
an output may differ by 2^-7 of sum_j p_j |v_j| (the same attention over
|v|) plus one bf16 step of the output: that is the tolerance.  On the
CPU: which (device, dtype, head dim, policy) takes the kernel, the
kernel's rows a block and tiles, the span and its path, and the two
metric readers of the ``model.paged_attend`` span.
"""
import dataclasses

import pytest
import torch

from perfbench import hostspans, spec
from repro_torch import api, configs, obs
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import layers as L, lm

BF16_STEP = 2.0 ** -7
KERNEL = api.Policy(backend="kernel")
AUTO = api.Policy(backend="auto")
LIBRARY = api.Policy(backend="library")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


def _pools(g, *, B, Hkv, rep, hd, BS, nmax, lens, C=1, spread=1.0):
    """Pools with a random null block 0, each slot's blocks at shuffled
    pool ids, tables padded with the null block, and q for C rows ending
    at each slot's length (``lens[b] == 0``: an inactive slot, its table
    all null and its q_pos 0)."""
    need = [-(-max(n, 1) // BS) for n in lens]
    P = 1 + sum(need)
    k = torch.randn((P, Hkv, BS, hd), generator=g).bfloat16()
    v = torch.randn((P, Hkv, BS, hd), generator=g).bfloat16()
    ids = (torch.randperm(P - 1, generator=g) + 1).tolist()
    table = torch.zeros((B, nmax), dtype=torch.int64)
    q_pos = torch.zeros((B, C), dtype=torch.int64)
    for b, n in enumerate(lens):
        if n:
            table[b, :need[b]] = torch.tensor(ids[:need[b]])
            ids = ids[need[b]:]
            q_pos[b] = torch.arange(n - C, n)
    q = (spread * torch.randn((B, Hkv * rep, C, hd), generator=g)).bfloat16()
    return q, k, v, table, q_pos


def _check(dev, q, k, v, table, q_pos, **kw):
    """The kernel's output against the plain path's on the card, within
    the tolerance above; returns the kernel's output."""
    args = [t.to(dev) for t in (q, k, v, table, q_pos)]
    if kw.get("decode_from") is not None:
        kw = dict(kw, decode_from=kw["decode_from"].to(dev))
    n = pa.launch_count()
    got = pa.paged_attention(*args, **kw)
    assert pa.launch_count() == n + 1
    want = pa.paged_attention_plain(*args, **kw)
    bound = pa.paged_attention_plain(args[0], args[1], args[2].abs(),
                                     *args[3:], **kw)
    got, want, bound = got.float(), want.float(), bound.float()
    assert torch.isfinite(got).all()
    tol = BF16_STEP * (bound + want.abs()) + 1e-6
    err = (got - want).abs()
    assert (err <= tol).all(), (err - tol).max().item()
    return got


#: decode rows: (B, Hkv, rep, hd, BS, nmax, lens, window)
DECODE = [
    (1, 4, 1, 128, 16, 72, [17], None),
    (1, 2, 4, 64, 16, 8, [1], None),
    (32, 16, 1, 128, 16, 72,
     [1, 15, 16, 17, 1152, 0, 200, 0] * 4, None),         # the chat cell
    (4, 2, 8, 256, 16, 72, [1152, 15, 0, 33], None),
    (3, 1, 4, 256, 16, 72, [1152, 600, 100], 512),        # gemma3's local
    (5, 4, 4, 64, 8, 16, [1, 8, 9, 128, 0], None),        # block size 8
]


@pytest.mark.card
@pytest.mark.parametrize("case", DECODE, ids=lambda c: (
    f"B{c[0]}kv{c[1]}r{c[2]}d{c[3]}bs{c[4]}w{c[7]}"))
@pytest.mark.parametrize("spread", [1.0, 4.0])
def test_decode_matches_plain(card, case, spread):
    B, Hkv, rep, hd, BS, nmax, lens, window = case
    g = torch.Generator().manual_seed(hd + B)
    q, k, v, table, q_pos = _pools(g, B=B, Hkv=Hkv, rep=rep, hd=hd, BS=BS,
                                   nmax=nmax, lens=lens, spread=spread)
    _check(card, q, k, v, table, q_pos, scale=hd ** -0.5, window=window)


#: prefill chunks of C 32: (Hkv, rep, hd, BS, nmax, end, n_prompt, window)
#: ``end`` the chunk's last position + 1; ``n_prompt`` None: no replay
#: rows, else rows at positions >= n_prompt take the decode order
PREFILL = [
    (4, 1, 128, 16, 72, 32, None, None),       # a fresh prompt's chunk
    (16, 1, 128, 16, 72, 300, 280, None),      # replay rows inside it
    (2, 4, 64, 16, 72, 1152, 1130, None),      # the table's last chunk
    (2, 8, 64, 8, 144, 64, None, None),
    (1, 4, 256, 16, 72, 900, None, 512),       # gemma3's window
    (1, 4, 256, 16, 72, 700, 690, 512),
]


@pytest.mark.card
@pytest.mark.parametrize("case", PREFILL, ids=lambda c: (
    f"kv{c[0]}r{c[1]}d{c[2]}bs{c[3]}end{c[5]}df{c[6]}w{c[7]}"))
def test_prefill_chunk_matches_plain(card, case):
    Hkv, rep, hd, BS, nmax, end, n_prompt, window = case
    g = torch.Generator().manual_seed(end)
    q, k, v, table, q_pos = _pools(g, B=1, Hkv=Hkv, rep=rep, hd=hd, BS=BS,
                                   nmax=nmax, lens=[end], C=32)
    dfrom = None if n_prompt is None else torch.tensor([n_prompt])
    _check(card, q, k, v, table, q_pos, scale=hd ** -0.5, window=window,
           decode_from=dfrom)


@pytest.mark.card
@pytest.mark.parametrize("hd", [128, 256])
def test_a_table_past_shared_memory_is_scored_in_tiles(card, hd):
    """65536 keys: one row's scores pass the 227 KB of shared memory, so
    the kernel takes the slot's range in tiles; decode rows and a chunk
    with replay rows at the table's end, and one slot far shorter."""
    BS, nmax = 16, 4096
    assert pa.tile_blocks(1, hd, BS, nmax) < nmax
    g = torch.Generator().manual_seed(hd)
    q, k, v, table, q_pos = _pools(g, B=2, Hkv=1, rep=4, hd=hd, BS=BS,
                                   nmax=nmax, lens=[nmax * BS, 300])
    _check(card, q, k, v, table, q_pos, scale=hd ** -0.5)
    q, k, v, table, q_pos = _pools(g, B=1, Hkv=1, rep=4, hd=hd, BS=BS,
                                   nmax=nmax, lens=[nmax * BS], C=32)
    _check(card, q, k, v, table, q_pos, scale=hd ** -0.5,
           decode_from=torch.tensor([nmax * BS - 10]))


@pytest.mark.card
@pytest.mark.parametrize("case", DECODE[2:] + [
    (1, 4, 1, 128, 16, 72, [1152], 64)], ids=lambda c: (
    f"B{c[0]}kv{c[1]}r{c[2]}d{c[3]}bs{c[4]}w{c[7]}"))
def test_decode_in_tiles_matches_plain(card, monkeypatch, case):
    """The decode cases under a shared-memory limit that holds the ring,
    q and one row's scores over 9 table blocks: every slot reaching more
    blocks is scored in tiles."""
    B, Hkv, rep, hd, BS, nmax, lens, window = case
    monkeypatch.setattr(pa, "SMEM_MAX", pa.smem_bytes(1, hd, BS, 9 * BS))
    assert pa.tile_blocks(1, hd, BS, nmax) == 9
    g = torch.Generator().manual_seed(hd + B + 1)
    q, k, v, table, q_pos = _pools(g, B=B, Hkv=Hkv, rep=rep, hd=hd, BS=BS,
                                   nmax=nmax, lens=lens)
    _check(card, q, k, v, table, q_pos, scale=hd ** -0.5, window=window)


@pytest.mark.card
@pytest.mark.parametrize("case", PREFILL, ids=lambda c: (
    f"kv{c[0]}r{c[1]}d{c[2]}bs{c[3]}end{c[5]}df{c[6]}w{c[7]}"))
def test_prefill_chunk_in_tiles_matches_plain(card, monkeypatch, case):
    """The prefill chunks with tiles of 8 blocks (of 16 keys) or 16 (of 8):
    a chunk's rows start and end in different tiles."""
    Hkv, rep, hd, BS, nmax, end, n_prompt, window = case
    monkeypatch.setattr(pa, "SMEM_MAX", pa.smem_bytes(1, hd, BS, 128))
    g = torch.Generator().manual_seed(end + 1)
    q, k, v, table, q_pos = _pools(g, B=1, Hkv=Hkv, rep=rep, hd=hd, BS=BS,
                                   nmax=nmax, lens=[end], C=32)
    dfrom = None if n_prompt is None else torch.tensor([n_prompt])
    _check(card, q, k, v, table, q_pos, scale=hd ** -0.5, window=window,
           decode_from=dfrom)


def _tiny_olmo():
    """olmo-smoke at head dim 64 (a kernel instance), 2 kv heads."""
    return dataclasses.replace(configs.get_smoke("olmo-1b"), head_dim=64,
                               n_kv_heads=2)


@pytest.mark.card
def test_decode_call_launches_once_a_layer_and_never_syncs(card):
    cfg = _tiny_olmo()
    params = lm.init_lm(cfg, torch.Generator(device=card).manual_seed(0),
                        device=card)
    slots, BS, nmax = 4, 16, 4
    ps = lm.init_paged_state(cfg, 1 + slots * nmax, BS, slots, device=card)
    table = torch.arange(1, 1 + slots * nmax, device=card).reshape(
        slots, nmax)
    table[3] = 0                                          # inactive slot
    pos = torch.tensor([0, 5, 40, 0], device=card)
    active = torch.tensor([True, True, True, False], device=card)
    toks = torch.randint(0, cfg.vocab, (slots, 1), device=card)
    with torch.no_grad():
        for be in (KERNEL, AUTO):
            lm.paged_decode(params, cfg, be, toks, ps, table, pos, active)
            torch.cuda.synchronize()
            n = pa.launch_count()
            torch.cuda.set_sync_debug_mode("error")
            try:
                lm.paged_decode(params, cfg, be, toks, ps, table, pos,
                                active)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert pa.launch_count() == n + cfg.n_layers
        n = pa.launch_count()
        lm.paged_decode(params, cfg, LIBRARY, toks, ps, table, pos, active)
        assert pa.launch_count() == n              # the plain ops


# -- CPU: the path choice, the rows a block, the span ------------------------

@pytest.mark.parametrize("device,dtype,hd,be,want", [
    ("cuda", torch.bfloat16, 128, AUTO, True),
    ("cuda", torch.bfloat16, 64, KERNEL, True),
    ("cuda", torch.bfloat16, 256, AUTO, True),
    ("cuda", torch.bfloat16, 128, LIBRARY, False),     # the forced library
    ("cuda", torch.bfloat16, 128,
     api.Policy(backend="auto", kernels="library"), False),
    ("cuda", torch.float32, 128, AUTO, False),         # f32 pools
    ("cuda", torch.bfloat16, 112, AUTO, False),        # zamba2's head dim
    ("cuda", torch.bfloat16, 20, AUTO, False),         # smollm's
    ("cpu", torch.bfloat16, 128, AUTO, False),
    ("cpu", torch.float32, 64, KERNEL, False),
])
def test_which_calls_take_the_kernel(device, dtype, hd, be, want):
    assert pa.applies(be.use_kernels, torch.device(device), dtype,
                      hd) is want


def test_rows_a_block_fill_the_card_and_fit_its_shared_memory():
    rpb = pa.rows_per_block
    assert rpb(1, 128, 16, 1152, 32 * 16) == 1         # olmo's decode
    assert rpb(6, 128, 16, 1152, 32 * 8) == 8          # mixtral's, B 32
    assert rpb(6, 128, 16, 1152, 4 * 8) == 1           # B 4: fill the card
    assert rpb(32, 128, 16, 1152, 16) == 2             # a chat chunk
    assert rpb(16 * 32, 128, 16, 8192, 64) == 4        # by shared memory
    assert pa.smem_bytes(4, 128, 16, 8192) <= pa.SMEM_MAX < \
        pa.smem_bytes(8, 128, 16, 8192)
    assert rpb(16 * 32, 128, 16, 1 << 16, 64) == 1     # one row, in tiles
    assert pa.tile_blocks(1, 128, 16, 72) == 72        # the whole table
    assert pa.tile_blocks(8, 128, 16, 72) == 72
    assert pa.tile_blocks(4, 128, 16, 512) == 512      # 8192 keys at R 4
    tb = pa.tile_blocks(1, 256, 16, 4096)              # 65536 keys
    assert 1 < tb < 4096
    assert pa.smem_bytes(1, 256, 16, tb * 16) <= pa.SMEM_MAX < \
        pa.smem_bytes(1, 256, 16, (tb + 1) * 16)
    assert pa.applies(True, torch.device("cuda"), torch.bfloat16, 256)


def test_cpu_calls_take_the_plain_path_inside_the_span():
    g = torch.Generator().manual_seed(0)
    q, k, v, table, q_pos = _pools(g, B=2, Hkv=2, rep=2, hd=64, BS=8,
                                   nmax=4, lens=[9, 20], C=4)
    want = pa.paged_attention_plain(q, k, v, table, q_pos, scale=0.125)
    obs.reset()
    with obs.capture():
        got = L.paged_attend(q, k, v, table, q_pos, AUTO, scale=0.125)
    recs = [r for r in obs.spans() if r.name == "model.paged_attend"]
    assert [r.attrs for r in recs] == [{"path": "plain"}]
    assert torch.equal(got, want)
    assert torch.equal(pa.paged_attention(q, k, v, table, q_pos,
                                          scale=0.125), want)


# -- the two readers of the span ---------------------------------------------

OFF = 5_000.0


def _ctx(recs, paths):
    """Two engine steps of the traced slice, each with one decode call
    whose attention holds a ``model.paged_attend`` record per path."""
    spans = [("perfbench.slice", OFF, OFF + 2000)]
    for k in range(2):
        t = 1000.0 * k
        recs.append(obs.SpanRecord("serve.step", int((t + 100) * 1e3),
                                   int((t + 900) * 1e3), -1, None, None,
                                   None))
        s = len(recs) - 1
        for j, path in enumerate(paths):
            a = t + 200 + 100 * j
            recs.append(obs.SpanRecord("model.paged_attend", int(a * 1e3),
                                       int((a + 50) * 1e3), s, None,
                                       {"path": path}, None))
        spans.append(("perfbench.step", OFF + t + 100, OFF + t + 930))
    return {"kind": "serve", "slice_steps": 2,
            "slice": {"t0": OFF, "t1": OFF + 2000, "spans": spans,
                      "kernels": []}}


@pytest.mark.parametrize("paths,ms,share", [
    (("kernel", "kernel"), 0.1, 100.0),
    (("kernel", "plain", "plain", "plain"), 0.2, 25.0),
    ((), None, None),                 # a program without the span
])
def test_paged_attend_readers(monkeypatch, paths, ms, share):
    recs = []
    monkeypatch.setattr(hostspans, "records", lambda: list(recs))
    ctx = _ctx(recs, paths)
    got_ms = spec.reader("paged_attend_ms.serve")(ctx)
    got_share = spec.reader("paged_attn_kernel_share.serve")(ctx)
    assert got_ms == (None if ms is None else pytest.approx(ms))
    assert got_share == (None if share is None else pytest.approx(share))
    assert spec.reader("paged_attend_ms.serve")(dict(ctx, kind="train")) \
        is None
