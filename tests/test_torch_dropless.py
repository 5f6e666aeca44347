"""The dropless MoE layer: each expert's rows in sorted row tiles on the
ragged kernel (``layers._dropless_moe``), at mixtral-smoke's size with
``MoEConfig.dropless``.

On the CPU (every kernel wrapper runs its plain version): the worst-case
tile table by hand and over random routings; the tile layer against the
capacity layout at C = T (no pair dropped) and against a plain
per-expert loop in f64; which calls take the tiles (serving calls under
a kernel family, and only where the router keeps every tile on the
kernel); paged prefill then decode through the tiles against one full
forward; the ragged wrapper's idle tiles; the device tally.  On the card
(tests marked ``card``): the ragged kernel with idle tiles at
mixtral-8x22b's decode shapes, and one decode call at its widths with
no host sync, its expert GEMMs all ragged launches.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import api, configs, obs
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.models import layers as L, lm

AUTO = api.Policy(backend="auto")
KERNEL = api.Policy(backend="kernel")
LIBRARY = api.named_policy("library")


def _dropless(cfg, **kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dropless=True), **kw)


def _smoke():
    """mixtral-smoke, dropless, in f32."""
    return _dropless(configs.get_smoke("mixtral-8x22b"), dtype="float32")


def _params(cfg, seed=0):
    return lm.init_lm(cfg, torch.Generator().manual_seed(seed), device="cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


# -- the tile table ------------------------------------------------------------

def test_tile_table_by_hand():
    """Six tokens, top-2 of 4, tiles of 2 rows: expert 1 has six pairs
    (three tiles), expert 0 three (two tiles, the second half empty),
    experts 2 and 3 one tile each; the table holds 4 + 6 tiles, the last
    three idle."""
    top_e = torch.tensor([[0, 1], [1, 2], [1, 0], [3, 1], [1, 2], [1, 0]])
    ids, rows, inv, counts, tiles = L.tile_table(top_e, 4, 2)
    assert ids.dtype == torch.int32
    assert ids.tolist() == [0, 0, 1, 1, 1, 2, 3, -1, -1, -1]
    assert counts.tolist() == [3, 6, 2, 1] and tiles.tolist() == [2, 3, 1, 1]
    # each pair's row, token-major: tokens keep their order in an expert
    assert rows.tolist() == [0, 4, 5, 10, 6, 1, 12, 7, 8, 11, 9, 2]
    # the token each row reads; 6 (the zero row) pads and fills idle tiles
    assert inv.tolist() == [0, 2, 5, 6, 0, 1, 2, 3, 4, 5, 1, 4, 3, 6] + [6] * 6


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("T,E,k", [(32, 8, 2), (5, 8, 2), (40, 6, 3),
                                   (1, 4, 2)])
def test_tile_table_holds_any_routing(seed, T, E, k):
    """Skewed random routings (one expert favoured): every pair lands in
    a row of its own inside its expert's tiles; the live tiles come first,
    in expert order, and fit the E + ceil(T k / bm) tiles."""
    g = torch.Generator().manual_seed(seed)
    w = torch.rand(E, generator=g) ** 4 + 1e-3
    top_e = torch.stack([torch.multinomial(w, k, generator=g)
                         for _ in range(T)])
    bm = L.dropless_tile(T, dataclasses.replace(
        configs.get_smoke("mixtral-8x22b").moe, num_experts=E, top_k=k))
    ids, rows, inv, counts, tiles = L.tile_table(top_e, E, bm)
    n = E + -(-T * k // bm)
    assert ids.shape == (n,) and inv.shape == (n * bm,)
    live = int(tiles.sum())
    assert live <= n
    assert ids[:live].tolist() == sorted(ids[:live].tolist())
    assert (ids[live:] == -1).all()
    assert rows.unique().numel() == T * k
    flat = top_e.reshape(-1)
    assert (ids[rows // bm].long() == flat).all()
    assert (inv[rows] == torch.arange(T * k) // k).all()
    assert int((inv < T).sum()) == T * k
    assert counts.tolist() == torch.bincount(flat, minlength=E).tolist()


def test_row_tile_rule():
    """Twice the mean rows an expert gets, up to a multiple of 8."""
    m = configs.get_config("mixtral-8x22b").moe
    assert [L.dropless_tile(T, m) for T in (1, 8, 16, 32, 33, 64, 256)] == \
        [8, 8, 8, 16, 24, 32, 128]


# -- the layer -----------------------------------------------------------------

def _plain_moe(p, x2, k):
    """The block as a loop over the experts in f64: softmax over the
    experts, top-k, renormalised, each expert on exactly its tokens."""
    x = x2.double()
    probs = torch.softmax(x @ p.router.double(), -1)
    top_p, top_e = torch.topk(probs, k, -1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(p.w_gate.shape[0]):
        t, j = torch.nonzero(top_e == e, as_tuple=True)
        if t.numel():
            h = F.silu(x[t] @ p.w_gate[e].double()) * (x[t] @ p.w_up[e].double())
            y.index_add_(0, t, top_p[t, j, None] * (h @ p.w_down[e].double()))
    return y


@pytest.mark.parametrize("be", [AUTO, KERNEL], ids=["auto", "kernel"])
@pytest.mark.parametrize("B,S", [(4, 1), (1, 32), (3, 7), (32, 1)])
def test_tiles_equal_capacity_and_the_plain_loop(be, B, S):
    cfg = _smoke()
    blk = _params(cfg).blocks[1]
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(B * 100 + S))
    with torch.no_grad(), obs.capture():
        obs.reset()
        y, aux = L.moe(blk.moe, x, be, cfg, serving=True)
        names = [r.name for r in obs.spans()]
        cap, _ = L.moe(blk.moe, x, be, cfg, serving=False)
    assert aux == 0.0
    assert names == ["model.moe.dispatch", "model.moe.experts",
                     "model.moe.combine"]
    assert obs.tallies()["moe"]["calls"] == 1
    scale = float(cap.abs().max())
    assert float((y - cap).abs().max()) <= 1e-6 * scale
    want = _plain_moe(blk.moe, x.reshape(B * S, -1), cfg.moe.top_k)
    assert float((y.reshape(B * S, -1).double() - want).abs().max()) <= \
        1e-5 * scale


def test_which_calls_take_the_tiles():
    """Serving calls of a dropless config under a kernel family; not the
    library family, not a whole-sequence call, not a config that drops
    (its capacity stays its own), and not a row tile the router sends to
    the library (mixtral-8x22b's widths: bm 16 stays, 64 goes)."""
    cfg = _smoke()
    blk = _params(cfg).blocks[0]
    x = torch.randn(2, 4, cfg.d_model)

    def tiled(cfg, be, serving):
        with torch.no_grad(), obs.capture():
            obs.reset()
            L.moe(blk.moe, x, be, cfg, serving=serving)
            return any(r.name == "model.moe.dispatch" for r in obs.spans())
    assert tiled(cfg, AUTO, True) and tiled(cfg, KERNEL, True)
    assert not tiled(cfg, LIBRARY, True)
    assert not tiled(cfg, AUTO, False)
    assert not tiled(configs.get_smoke("mixtral-8x22b"), AUTO, True)
    full = _dropless(configs.get_config("mixtral-8x22b"))
    assert L.dropless_tile(32, full.moe) == 16
    routes = L._tile_routes(AUTO, full, 16, torch.bfloat16)
    assert [r.blocks for r in routes] == [
        gg.pick_blocks(16, 6144, 16384, torch.bfloat16)] * 2 + [
        gg.pick_blocks(16, 16384, 6144, torch.bfloat16)]
    assert L._tile_routes(AUTO, full, 64, torch.bfloat16) is None
    assert L._tile_routes(LIBRARY, full, 16, torch.bfloat16) is None
    # the capacity layout of a dropless config holds every token
    assert L._capacity(32, full.moe) == 32 and L._capacity(200, full.moe) \
        == 256


def test_paged_prefill_then_decode_match_one_forward():
    """Two slots through ``paged_prefill`` (a 13-token prompt in a chunk of
    16, then a 5-token one) and four ``paged_decode`` steps, every MoE
    layer on the tiles, against ``forward_train`` over each whole
    sequence (the capacity layout at C = T)."""
    cfg = _smoke()
    params = _params(cfg, seed=3)
    rng = np.random.RandomState(0)
    BS, nmax, slots, C = 8, 4, 2, 16
    ps = lm.init_paged_state(cfg, 1 + slots * nmax, BS, slots,
                             dtype=torch.float32, device="cpu")
    table = torch.arange(1, 1 + slots * nmax).reshape(slots, nmax)
    prompts = [rng.randint(0, cfg.vocab, n) for n in (13, 5)]
    seqs = [list(p) for p in prompts]
    got = [[], []]
    with torch.no_grad(), obs.capture():
        obs.reset()
        for s, p in enumerate(prompts):
            toks = torch.zeros((1, C), dtype=torch.long)
            toks[0, :len(p)] = torch.from_numpy(p)
            lg = lm.paged_prefill(params, cfg, AUTO, toks, ps, table[s:s + 1],
                                  torch.tensor([0]), s, len(p), len(p))
            got[s].append(lg[0, len(p) - 1])
            seqs[s].append(int(lg[0, len(p) - 1].argmax()))
        for _ in range(4):
            pos = torch.tensor([len(q) - 1 for q in seqs])
            toks = torch.tensor([[q[-1]] for q in seqs])
            lg = lm.paged_decode(params, cfg, AUTO, toks, ps, table, pos)
            for s in range(slots):
                got[s].append(lg[s, 0])
                seqs[s].append(int(lg[s, 0].argmax()))
        tiled = sum(r.name == "model.moe.dispatch" for r in obs.spans())
    assert tiled == cfg.n_layers * (2 + 4)
    for s, p in enumerate(prompts):
        full = torch.tensor(seqs[s][:-1])[None]
        want, _ = lm.forward_train(params, cfg, AUTO, full)
        want = want[0, len(p) - 1:]
        have = torch.stack(got[s])
        scale = float(want.abs().max())
        assert float((have - want).abs().max()) <= 1e-5 * scale


# -- the ragged wrapper's idle tiles and the tally -----------------------------

def test_idle_tiles_give_zero_rows_and_skip_the_check():
    g = torch.Generator().manual_seed(5)
    x, w = torch.randn(32, 24, generator=g), torch.randn(3, 24, 40,
                                                         generator=g)
    ids = torch.tensor([2, 0, -1, -1], dtype=torch.int32)
    out = gg.ragged_gemm(x, w, ids, bm=8, idle_tiles=True)
    assert (out[16:] == 0).all()
    for t in range(2):
        want = x[8 * t:8 * t + 8] @ w[int(ids[t])]
        assert torch.allclose(out[8 * t:8 * t + 8], want, atol=1e-5)
    with pytest.raises(ValueError, match="tile_group_ids"):
        gg.ragged_gemm(x, w, ids, bm=8)


def test_tally_sums_on_the_device_and_resets():
    obs.reset()
    fields = ("a", "b")
    obs.tally("t", fields, torch.tensor([1, 2]))
    obs.tally("t", fields, torch.tensor([3, 4]))
    assert obs.tallies() == {"t": {"a": 4, "b": 6, "calls": 2}}
    obs.reset()
    assert obs.tallies() == {}


# -- on the card -----------------------------------------------------------------

@pytest.mark.card
def test_ragged_kernel_with_idle_tiles_at_mixtral_shapes(card):
    """Gate/up (6144 -> 16384) and down (16384 -> 6144), 8 experts, row
    tiles of 16 as the tile table lays out 32 tokens: live tiles against
    the plain version at bf16's tolerance (f32 sums of the same products
    in another order, one rounding: 8e-3 of the largest output)."""
    g = torch.Generator(device=card).manual_seed(0)
    top_e = torch.stack([torch.randperm(8, generator=g, device=card)[:2]
                         for _ in range(32)])
    ids, _, inv, _, tiles = L.tile_table(top_e, 8, 16)
    live = int(tiles.sum())
    assert int((ids < 0).sum()) == ids.numel() - live > 0
    for K, N in ((6144, 16384), (16384, 6144)):
        x = torch.randn(ids.numel() * 16, K, generator=g, device=card) \
            .bfloat16() * (inv < 32)[:, None]
        w = (torch.randn(8, K, N, generator=g, device=card)
             / K ** 0.5).bfloat16()
        got = gg.ragged_gemm(x, w, ids, bm=16, idle_tiles=True)
        want = gg.ragged_gemm_plain(x, w, ids, 16)
        rows = live * 16
        err = (got[:rows].float() - want[:rows].float()).abs().max()
        assert float(err) <= 8e-3 * float(want[:rows].float().abs().max())


@pytest.mark.card
def test_mixtral_decode_call_never_syncs(card):
    """One layer of mixtral-8x22b at its widths, 32 slots: a decode call
    under ``set_sync_debug_mode("error")``, each MoE layer three ragged
    launches and no batched one."""
    cfg = _dropless(configs.get_config("mixtral-8x22b"), n_layers=1)
    params = lm.init_lm(cfg, torch.Generator(device=card).manual_seed(0),
                        device=card)
    slots, BS, nmax = 32, 16, 4
    ps = lm.init_paged_state(cfg, 1 + slots * nmax, BS, slots, device=card)
    table = torch.arange(1, 1 + slots * nmax, device=card).reshape(
        slots, nmax)
    g = torch.Generator(device=card).manual_seed(1)
    pos = torch.randint(0, nmax * BS, (slots,), generator=g, device=card)
    toks = torch.randint(0, cfg.vocab, (slots, 1), generator=g, device=card)
    with torch.no_grad():
        lm.paged_decode(params, cfg, AUTO, toks, ps, table, pos)
        torch.cuda.synchronize()
        r, b = gg.launch_count("ragged_gemm"), gg.launch_count("batched_gemm")
        torch.cuda.set_sync_debug_mode("error")
        try:
            lg = lm.paged_decode(params, cfg, AUTO, toks, ps, table, pos)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert gg.launch_count("ragged_gemm") == r + 3 * cfg.n_layers
    assert gg.launch_count("batched_gemm") == b
    assert bool(torch.isfinite(lg).all())
