"""The SSD scan's chunk-parallel schedule and its launches, on the CPU.

On the card a scan is three launches (``csrc/ssd.cu``): each chunk's own
state s_c = Σ_s B_s ⊗ (w_s x_s); the state pass h_c = exp(total_{c-1})
h_{c-1} + s_{c-1}; and per (batch, chunk, group of heads) C Bᵀ's lower
triangle formed once, then y = exp(cum) (C @ h_c) + (C Bᵀ ⊙ L ⊙ dt) @ x
per head; the cumsum of dt*A is one warp's scan (a run of chunk/32 a
lane, then the lanes' totals by shuffles).  None of that runs here, so:

* a plain emulation of that schedule, in f32 with the kernels' orders of
  operations, is held against JAX's Pallas ``ssd_scan`` in interpret mode
  on the same numpy inputs, at the existing tests' shapes (S not a
  multiple of the chunk, decays that overflow above the diagonal, the
  strided views the model passes, bf16), at the reference's tolerance
  (rtol 1e-4, atol 1e-5; bf16 at one bf16 step of the largest output, as
  ``chip_smoke.py`` holds the kernel);
* the launch plan (``ssd.launch_plan``: chunks, heads a block, launches)
  and its shared memory, as arithmetic on shapes;
* the launch's C call with the built library stubbed out: its arguments,
  the scratch of the chunk states, and the exact counts of launches and
  scans.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import vmem
from repro_torch.kernels import build, ssd

RTOL, ATOL = 1e-4, 1e-5


def _inputs(rng, Bt, S, H, P, N):
    """The reference tests' SSD inputs (``_ssd_inputs``), as numpy."""
    x = (rng.randn(Bt, S, H, P) * 0.3).astype(np.float32)
    dt = (np.abs(rng.randn(Bt, S, H)) * 0.1 + 0.01).astype(np.float32)
    A = (-np.abs(rng.randn(H)) * 0.5 - 0.1).astype(np.float32)
    B = (rng.randn(Bt, S, 1, N) * 0.3).astype(np.float32)
    C = (rng.randn(Bt, S, 1, N) * 0.3).astype(np.float32)
    return x, dt, A, B, C


def _warp_cumsum(da):
    """The kernels' chunk cumsum of da (chunk,), f32: lane l sums its run
    of chunk/32 in order, the lanes' totals are scanned by shuffles
    (Hillis-Steele, offsets 1, 2, 4, 8, 16), and each run adds the scan
    of the lanes before it."""
    ch = da.shape[0]
    e = max(1, ch // 32)
    runs = np.zeros((32, e), np.float32)
    tot = np.zeros(32, np.float32)
    for lane in range(32):
        r = np.float32(0)
        for i in range(e):
            s = lane * e + i
            r = np.float32(r + (da[s] if s < ch else np.float32(0)))
            runs[lane, i] = r
        tot[lane] = r
    incl = tot.copy()
    off = 1
    while off < 32:
        up = incl.copy()
        incl[off:] = (incl[off:] + up[:-off]).astype(np.float32)
        off *= 2
    before = np.concatenate([[np.float32(0)], incl[:-1]]).astype(np.float32)
    cum = np.zeros(ch, np.float32)
    for lane in range(32):
        for i in range(e):
            s = lane * e + i
            if s < ch:
                cum[s] = np.float32(before[lane] + runs[lane, i])
    return cum


def _schedule(x, dt, A, B, C, chunk):
    """The three launches of one scan, emulated in plain torch, f32:
    states, state pass, outputs with C Bᵀ once a (batch, chunk); x and
    the states held ``ssd.padded(P)`` wide, the columns past P zero, and
    y cut back to P, as the kernels hold them."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    x = torch.nn.functional.pad(x, (0, ssd.padded(P) - P))
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def chunks(t):
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.ndim - 2)
                                    + (0, pad))
        return t.reshape(Bt, nc, chunk, *t.shape[2:])

    xc, dtc = chunks(x), chunks(dt)                  # (Bt, nc, ch, H, P)
    Bc, Cc = chunks(B[:, :, 0]), chunks(C[:, :, 0])  # (Bt, nc, ch, N)
    da = (dtc * A.float()).numpy()                   # dA rounded once
    cum = np.zeros_like(da)
    for b in range(Bt):
        for c in range(nc):
            for h in range(H):
                cum[b, c, :, h] = _warp_cumsum(da[b, c, :, h])
    cum = torch.from_numpy(cum)                      # (Bt, nc, ch, H)
    total = cum[:, :, -1]                            # (Bt, nc, H)
    # 1. each chunk's own state, Σ_s B_s ⊗ (w_s x_s)
    w = dtc * torch.exp(total[:, :, None] - cum)
    states = torch.einsum("bcsn,bcshp->bchnp", Bc, w[..., None] * xc)
    # 2. the state entering each chunk
    hin = torch.zeros_like(states)
    run = torch.zeros_like(states[:, 0])
    for c in range(nc):
        hin[:, c] = run
        run = torch.exp(total[:, c])[..., None, None] * run + states[:, c]
    # 3. C Bᵀ once a (batch, chunk); per head the scores and y
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    L = torch.where(tri[None, None, :, :, None], torch.exp(diff),
                    torch.zeros(()))
    scores = cb[..., None] * L * dtc[:, :, None]     # (Bt, nc, t, s, H)
    y = torch.exp(cum)[..., None] * torch.einsum("bctn,bchnp->bcthp", Cc,
                                                 hin)
    y = y + torch.einsum("bctsh,bcshp->bcthp", scores, xc)
    return y.reshape(Bt, nc * chunk, H, -1)[:, :S, :, :P].to(x.dtype)


def _jax(a, chunk):
    return np.asarray(jops.ssd_scan(*[jnp.asarray(t) for t in a],
                                    chunk=chunk, interpret=True))


@pytest.mark.parametrize("Bt,S,chunk", [(1, 17, 16), (2, 64, 16),
                                        (3, 100, 32), (2, 100, 16),
                                        (1, 40, 64)])
def test_schedule_matches_pallas_interpret(Bt, S, chunk):
    a = _inputs(np.random.RandomState(Bt * 31 + S), Bt, S, 2, 8, 16)
    got = _schedule(*[torch.from_numpy(t) for t in a], chunk).numpy()
    np.testing.assert_allclose(got, _jax(a, chunk), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("P", [4, 12, 20])
def test_schedule_pads_p_to_a_multiple_of_eight(P):
    """P a multiple of 4 but not of 8: the kernels hold x and the states
    at ``ssd.padded(P)`` columns; the plain version (the CPU path) takes
    such P too."""
    a = _inputs(np.random.RandomState(P), 2, 40, 2, P, 20)
    want = _jax(a, 16)
    tens = [torch.from_numpy(t) for t in a]
    np.testing.assert_allclose(_schedule(*tens, 16).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ssd.ssd_scan(*tens, chunk=16).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    assert ssd.padded(P) % 8 == 0 and 0 <= ssd.padded(P) - P < 8
    assert ssd.state_smem_bytes(16, 20, P) == \
        ssd.state_smem_bytes(16, 20, ssd.padded(P))


def test_schedule_finite_where_decay_overflows_above_diagonal():
    rng = np.random.RandomState(9)
    x, dt, A, B, C = _inputs(rng, 1, 48, 2, 8, 16)
    dt = np.full_like(dt, 2.0)
    A = np.array([-30.0, -5.0], np.float32)
    a = (x, dt, A, B, C)
    got = _schedule(*[torch.from_numpy(t) for t in a], 16)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _jax(a, 16), rtol=RTOL,
                               atol=ATOL)


def test_schedule_reads_the_models_strided_views():
    rng = np.random.RandomState(7)
    Bt, S, H, P, N = 2, 40, 2, 8, 16
    row = torch.from_numpy((rng.randn(Bt, S, H * P + 2 * N) * 0.3).astype(
        np.float32))
    _, dt, A, _, _ = _inputs(rng, Bt, S, H, P, N)
    x = row[..., :H * P].reshape(Bt, S, H, P)
    B = row[..., H * P:H * P + N].reshape(Bt, S, 1, N)
    C = row[..., H * P + N:].reshape(Bt, S, 1, N)
    assert not x.is_contiguous() and not B.is_contiguous()
    got = _schedule(x, torch.from_numpy(dt), torch.from_numpy(A), B, C, 16)
    want = _jax((x.numpy(), dt, A, B.numpy(), C.numpy()), 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_schedule_bf16_within_one_step():
    a = _inputs(np.random.RandomState(8), 1, 50, 2, 8, 16)
    x, dt, A, B, C = (torch.from_numpy(t) for t in a)
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, B, C))
    got = _schedule(xb, dt, A, Bb, Cb, 16)
    assert got.dtype == torch.bfloat16
    want = _jax((xb.float().numpy(), a[1], a[2], Bb.float().numpy(),
                 Cb.float().numpy()), 16)
    assert np.abs(got.float().numpy() - want).max() <= \
        2.0 ** -8 * np.abs(want).max() + 1e-6


def test_warp_cumsum_is_a_cumsum():
    rng = np.random.RandomState(3)
    for ch in (16, 32, 64, 128):
        da = (-np.abs(rng.randn(ch)) * 0.1).astype(np.float32)
        np.testing.assert_allclose(_warp_cumsum(da), np.cumsum(da),
                                   rtol=1e-6, atol=1e-6)


# -- the launch plan --------------------------------------------------------

def test_forward_train_shape_takes_three_launches_in_two_groupings():
    """mamba2-780m's forward_train scan: 16 chunks of 128, 48 heads;
    the state kernel (two blocks an SM) 6 heads a block, 15 x 8 x 2 = 240
    blocks; the output kernel (one an SM) 12, 16 x 4 x 2 = 128 blocks."""
    assert ssd.launch_plan(2, 2048, 48, 128, 64, 128) == (16, 6, 12)
    assert ssd.state_smem_bytes(128, 128, 64) == 101888
    assert ssd.out_smem_bytes(128, 128, 64) == 204288
    assert 2 * (ssd.state_smem_bytes(128, 128, 64)
                + vmem.SMEM_BLOCK_RESERVED) <= vmem.SMEM_SM_BYTES
    assert ssd.out_smem_bytes(max(ssd.CHUNKS), ssd.N_MAX, ssd.P_MAX) <= \
        vmem.SMEM_OPTIN_BYTES


@pytest.mark.parametrize("H", [1, 2, 4, 6, 48])
@pytest.mark.parametrize("blocks", [1, 3, 32, 200, 2000])
@pytest.mark.parametrize("resident", [1, 2])
def test_heads_per_block_minimises_the_waves(H, blocks, resident):
    hg = ssd.heads_per_block(H, blocks, resident)
    slots = vmem.NUM_SMS * resident

    def cost(g):
        return -(-blocks * (H // g) // slots) * g

    assert H % hg == 0
    assert all(cost(hg) <= cost(g) for g in range(1, H + 1) if H % g == 0)
    assert all(cost(g) > cost(hg) for g in range(hg + 1, H + 1)
               if H % g == 0)


@pytest.mark.parametrize("S,chunk,want", [(1, 16, 1), (16, 16, 1),
                                          (17, 16, 3), (128, 128, 1),
                                          (2048, 128, 3)])
def test_launches_per_scan(S, chunk, want):
    assert ssd.launches_per_scan(S, chunk) == want
    nc, hg1, _ = ssd.launch_plan(1, S, 4, 16, 8, chunk)
    assert (nc == 1) == (hg1 == 0) == (want == 1)


# -- the launch, with the library stubbed out --------------------------------

class _FakeLib:
    """Stands in for the built library: records each C call.  Its
    ``ssd_scan`` reports the kernels the C entry queues (three when it is
    handed the chunk states' scratch, else the output kernel alone), or
    ``queued`` and the error ``rc`` when those are set."""

    def __init__(self):
        self.calls = []
        self.rc, self.queued = 0, None

    def iaat_error_string(self, rc):
        return f"error {rc}".encode()

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            if name == "ssd_scan":
                args[-1].contents.value = self.queued if \
                    self.queued is not None else 1 if args[20] is None else 3
            return self.rc
        return entry


class _Stream:
    cuda_stream = 7


@pytest.fixture
def fake_lib(monkeypatch):
    import contextlib
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    ssd.reset_launch_count()
    yield lib
    ssd.reset_launch_count()


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", [(2, 2048, 48, 64, 128, 128),
                                              (1, 17, 4, 8, 16, 16),
                                              (3, 16, 2, 8, 16, 16)])
def test_launch_counts_launches_and_scans(fake_lib, Bt, S, H, P, N, chunk):
    x = torch.zeros((Bt, S, H, P))
    dt = torch.zeros((Bt, S, H))
    A = torch.zeros((H,))
    B = torch.zeros((Bt, S, 1, N))
    y = ssd._launch(x, dt, A, B, B, chunk)
    assert y.shape == x.shape
    nc, hg1, hg3 = ssd.launch_plan(Bt, S, H, N, P, chunk)
    k = ssd.launches_per_scan(S, chunk)
    ((name, args),) = fake_lib.calls
    assert name == "ssd_scan"
    assert args[13:20] == (Bt, S, H, N, P, hg1, hg3)
    assert (args[20] is None) == (nc == 1) and args[21] == 7
    assert args[22].contents.value == k
    assert ssd.launch_count() == k
    assert ssd.scan_count() == 1
    ssd._launch(x, dt, A, B, B, chunk)
    assert (ssd.launch_count(), ssd.scan_count()) == (2 * k, 2)


def test_launch_count_is_what_the_entry_queued(fake_lib):
    """A launch that fails after the state kernel was queued counts that
    one launch and no scan, and raises."""
    x = torch.zeros((1, 40, 2, 12))
    B = torch.zeros((1, 40, 1, 20))
    fake_lib.rc, fake_lib.queued = 700, 1
    with pytest.raises(RuntimeError, match="error 700"):
        ssd._launch(x, torch.zeros((1, 40, 2)), torch.zeros(2), B, B, 16)
    assert (ssd.launch_count(), ssd.scan_count()) == (1, 0)


def test_empty_scan_launches_nothing(fake_lib):
    x = torch.zeros((2, 0, 4, 8))
    y = ssd._launch(x, torch.zeros((2, 0, 4)), torch.zeros(4),
                    torch.zeros((2, 0, 1, 16)), torch.zeros((2, 0, 1, 16)),
                    16)
    assert y.shape == x.shape and not fake_lib.calls
    assert (ssd.launch_count(), ssd.scan_count()) == (0, 0)


# -- the bound chip_smoke.py reports -----------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("S,chunk", [(100, 128), (128, 128), (256, 128),
                                     (300, 128), (2048, 128)])
def test_ssd_bound_counts_only_the_work_the_scan_needs(S, chunk):
    """C @ h is not formed in the first chunk (zero initial state) and the
    state update not in the last (no final state): a scan of one chunk
    has neither, of two chunks one each a head."""
    Bt, H, P, N = 2, 48, 64, 128
    x = torch.empty((Bt, S, H, P), device="meta")
    B = torch.empty((Bt, S, 1, N), device="meta")
    flops, flops_head, nbytes = _chip_smoke()._ssd_bound(x, B, chunk)
    tri = 0
    for c0 in range(0, S, chunk):
        n = min(chunk, S - c0)
        tri += n * (n + 1) // 2
    # C @ h over every chunk but the first, the state update over every
    # chunk but the last: 2 N P a token each, less the first and last
    # chunks' tokens
    first, last = min(chunk, S), S - (-(-S // chunk) - 1) * chunk
    state = 2 * N * P * ((S - first) + (S - last))
    assert flops == Bt * (tri * 2 * N + H * (tri * 2 * P + state))
    assert flops_head == Bt * H * (tri * 2 * N + tri * 2 * P + state)
    assert nbytes == 2 * Bt * S * H * P * 4 + 2 * Bt * S * N * 4 \
        + Bt * S * H * 4 + H * 4
    if S == 2048:
        assert (flops, flops_head) == (7_730_626_560, 10_909_384_704)
