"""The port's flash attention and attention oracles against the JAX package's.

The same numpy inputs go through the JAX Pallas kernel in interpret mode
(``repro.kernels.flash_attention``, as the reference's own tests run it
on the CPU) and through the port's wrapper, which on a CPU tensor runs
its plain version.  Tolerances are the reference's
(``tests/test_kernels_other.py:25,41,53``): 2e-5 for its fixed cases,
3e-5 for its shape sweep, all in f32.  In bf16 both sides take f32 sums
of the same exact products and round once, so they differ by at most one
bf16 step (2^-7 relative).  The CUDA kernels themselves are held against
the plain version on the card by ``chip_smoke.py``; the tensor-core
kernel's arithmetic (bf16 products, f32 sums, P split into bf16 terms) is
emulated here in plain torch and held to the card's bf16 tolerance.
"""
import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import flash_attention as jflash, ref as jref
from repro_torch import api
from repro_torch.kernels import flash_attention as fa, ref
from repro_torch.models import layers as L

BF16_STEP = 2.0 ** -7


def _inputs(seed, B, Hq, Hkv, Sq, Sk, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Hq, Sq, D).astype(np.float32),
            rng.randn(B, Hkv, Sk, D).astype(np.float32),
            rng.randn(B, Hkv, Sk, D).astype(np.float32))


def _jax_flash(q, k, v, bq, bkv, dtype=jnp.float32, **kw):
    return np.asarray(jflash.flash_attention(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        bq=bq, bkv=bkv, interpret=True, **kw).astype(jnp.float32))


def _port(fn, q, k, v, dtype=torch.float32, **kw):
    out = fn(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), **kw)
    assert out.dtype == dtype
    return out.float().numpy()


#: (seed, B, Hq, Hkv, Sq, Sk, D, causal, window, q_offset, bq, bkv, tol):
#: the reference's causal x window cases, its GQA shape sweep (fixed
#: draws of its hypothesis ranges: (4,1)/(4,2)/(6,3), odd S, D 16/32/64),
#: its decode step, and a query past every key of its window (no valid
#: key: the row must come out 0, not NaN)
CASES = [
    (0, 2, 4, 2, 80, 80, 32, True, None, 0, 32, 32, 2e-5),
    (0, 2, 4, 2, 80, 80, 32, True, 24, 0, 32, 32, 2e-5),
    (0, 2, 4, 2, 80, 80, 32, False, None, 0, 32, 32, 2e-5),
    (0, 2, 4, 2, 80, 80, 32, False, 24, 0, 32, 32, 2e-5),
    (3, 1, 4, 1, 17, 17, 16, True, None, 0, 32, 32, 3e-5),
    (4, 2, 4, 2, 33, 33, 32, True, None, 0, 32, 32, 3e-5),
    (5, 3, 6, 3, 97, 97, 64, True, None, 0, 32, 32, 3e-5),
    (6, 2, 6, 3, 51, 51, 16, True, None, 0, 32, 32, 3e-5),
    (7, 1, 4, 2, 81, 81, 64, True, None, 0, 32, 32, 3e-5),
    (1, 2, 4, 2, 1, 64, 32, True, None, 63, 8, 32, 2e-5),
    (8, 1, 4, 1, 1, 64, 32, True, 24, 200, 8, 32, 2e-5),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: (
    f"B{c[1]}H{c[2]}x{c[3]}S{c[4]}x{c[5]}D{c[6]}c{int(c[7])}w{c[8]}o{c[9]}"))
def test_flash_matches_jax(case):
    seed, B, Hq, Hkv, Sq, Sk, D, causal, window, q_offset, bq, bkv, tol = case
    q, k, v = _inputs(seed, B, Hq, Hkv, Sq, Sk, D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = _jax_flash(q, k, v, bq, bkv, **kw)
    fa.reset_launch_count()
    for fn in (fa.flash_attention_plain, fa.flash_attention):
        got = _port(fn, q, k, v, **kw)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert fa.launch_count() == 0          # the CPU runs the plain version
    no_key = window is not None and q_offset - window >= Sk - 1
    if not no_key:
        oracle = np.asarray(jref.ref_mha(*map(jnp.asarray, (q, k, v)), **kw))
        np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)
    else:
        assert not got.any()


@pytest.mark.parametrize("window", [None, 24])
def test_flash_bf16_matches_jax_within_one_step(window):
    q, k, v = _inputs(9, 2, 4, 2, 80, 80, 32)
    want = _jax_flash(q, k, v, 32, 32, jnp.bfloat16, window=window)
    got = _port(fa.flash_attention, q, k, v, torch.bfloat16, window=window)
    np.testing.assert_allclose(got, want, rtol=BF16_STEP, atol=1e-6)


#: (Sq, Sk) of non-causal attention with Sq != Sk: cross attention, a
#: decoder's queries against an encoder's keys (one query at decode, a
#: prompt of 5, and more queries than keys)
CROSS = [(1, 37), (5, 130), (130, 5)]


@pytest.mark.parametrize("D", [16, 20])
@pytest.mark.parametrize("Sq,Sk", CROSS)
def test_flash_non_causal_sq_ne_sk_matches_jax(Sq, Sk, D):
    """GQA 8 over 2, D 16 and D 20 (zero-padded to 32), f32, against the
    reference's Pallas kernel in interpret mode at its sweep tolerance;
    bq and bkv as the reference's ``_full_attn`` picks them."""
    q, k, v = _inputs(Sq + Sk + D, 2, 8, 2, Sq, Sk, D)
    want = _jax_flash(q, k, v, min(128, Sq), 128, causal=False)
    got = _port(fa.flash_attention, q, k, v, causal=False)
    assert got.shape == want.shape == (2, 8, Sq, D)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
    oracle = np.asarray(jref.ref_mha(*map(jnp.asarray, (q, k, v)),
                                     causal=False))
    np.testing.assert_allclose(got, oracle, rtol=3e-5, atol=3e-5)


def test_flash_takes_strided_views():
    """The heads of ``layers._split_heads`` are transposed views; the
    wrapper takes them as they are, with the same result."""
    q, k, v = _inputs(10, 2, 4, 2, 23, 23, 16)
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2).contiguous()
                  .transpose(1, 2) for a in (q, k, v))
    assert not qt.is_contiguous()
    got = fa.flash_attention(qt, kt, vt, window=8)
    want = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              window=8)
    assert torch.equal(got, want)


def test_flash_refuses_bad_shapes_and_masks():
    q, k, v = (torch.from_numpy(a) for a in _inputs(11, 1, 3, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="GQA"):
        fa.flash_attention(q, k, v)
    q = q[:, :2]
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[..., :8], v)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(q, k, v, q_offset=-1)


@pytest.mark.parametrize("causal,window,q_offset,kv_chunk", [
    (True, None, 0, 16), (True, 7, 0, 16), (False, None, 0, 1024),
    (False, 9, 0, 32), (True, None, 30, 16), (True, 4, 40, 8)])
def test_chunked_mha_matches_jax(causal, window, q_offset, kv_chunk):
    q, k, v = _inputs(12, 2, 4, 2, 19, 50, 16)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = np.asarray(jref.chunked_mha(*map(jnp.asarray, (q, k, v)),
                                       kv_chunk=kv_chunk, **kw))
    got = _port(ref.chunked_mha, q, k, v, kv_chunk=kv_chunk, **kw)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (False, 6),
                                           (True, 6)])
def test_ref_mha_matches_jax(causal, window):
    q, k, v = _inputs(13, 1, 6, 3, 21, 21, 32)
    kw = dict(causal=causal, window=window)
    want = np.asarray(jref.ref_mha(*map(jnp.asarray, (q, k, v)), **kw))
    got = _port(ref.ref_mha, q, k, v, **kw)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("backend,kernel", [("kernel", True),
                                            ("auto", True),
                                            ("library", False)])
def test_full_attn_routes_by_policy(monkeypatch, backend, kernel):
    """A whole-prompt attention calls the flash kernel's module under
    every backend but the forced library, and ``chunked_mha`` there."""
    calls = []
    for mod, name in ((fa, "flash_attention"), (ref, "chunked_mha")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n), _o(*a, **k))[1])
    q, k, v = (torch.from_numpy(a) for a in _inputs(14, 1, 4, 2, 9, 9, 16))
    L._full_attn(q, k, v, api.named_policy(backend), causal=True,
                 window=None, q_offset=0, scale=0.25)
    assert calls == ["flash_attention" if kernel else "chunked_mha"]


# --------------------------------------------------------------------------
# The tensor-core kernel's arithmetic (csrc/flash_attention.cu,
# flash_attention_tc_kernel), emulated in plain torch on the CPU.
# --------------------------------------------------------------------------

#: keys per KV tile of the tensor-core kernel
TC_BKV = 64


def _split_terms(p, terms):
    """p (f32) as ``terms`` bf16 values, each the bf16 rounding of what the
    earlier ones leave: the A fragments the kernel feeds P V with."""
    out, rest = [], p
    for _ in range(terms):
        t = rest.to(torch.bfloat16).float()
        out.append(t)
        rest = rest - t
    return out


def _tc_emulation(q, k, v, *, causal, window=None, q_offset=0, terms=3):
    """The kernel's arithmetic: q k products of bf16 values (exact in f32)
    summed in f32, scaled, masked to NEG_INF, an online softmax over KV
    tiles of 64 keys with f32 max, p and sum, P split into ``terms`` bf16
    terms, each multiplied by bf16 V with f32 sums, and acc / max(l,
    1e-37) cast once to bf16."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    qf = q.float()
    kf = k.float().repeat_interleave(rep, 1)
    vf = v.float().repeat_interleave(rep, 1)
    qi = torch.arange(Sq)[:, None] + q_offset
    m = torch.full((B, Hq, Sq), fa.NEG_INF)
    l = torch.zeros(B, Hq, Sq)
    acc = torch.zeros(B, Hq, Sq, D)
    for k0 in range(0, Sk, TC_BKV):
        kb, vb = kf[:, :, k0:k0 + TC_BKV], vf[:, :, k0:k0 + TC_BKV]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * D ** -0.5
        ki = k0 + torch.arange(kb.shape[2])[None, :]
        ok = ki < Sk
        if causal:
            ok = ok & (ki <= qi)
        if window is not None:
            ok = ok & (ki > qi - window)
        s = torch.where(ok, s, torch.tensor(fa.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), torch.tensor(0.))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = sum(torch.einsum("bhqk,bhkd->bhqd", t, vb)
                 for t in _split_terms(p, terms))
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-37)[..., None]).to(q.dtype)


def _one_step_misses(got, want):
    """Outputs past chip_smoke.py's bf16 check: one bf16 step of the larger
    of the two values, plus 1e-6."""
    g, w = got.double(), want.double()
    lim = BF16_STEP * torch.maximum(g.abs(), w.abs()) + 1e-6
    return int(((g - w).abs() > lim).sum())


def _tc_cases(D):
    """The flash check's grid at one head dim (B 1, GQA 8/2), its decode
    query and its query with no valid key."""
    for S, causal, window in itertools.product((1, 23, 80, 300),
                                               (True, False),
                                               (None, 24, 512)):
        yield (1, 8, 2, S, S, D), dict(causal=causal, window=window)
    yield (3, 16, 16, 1, 64, D), dict(causal=True, q_offset=63)
    yield (1, 4, 1, 1, 64, D), dict(causal=True, q_offset=200, window=24)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_tc_kernel_arithmetic_within_one_bf16_step(D):
    """P split into three bf16 terms (p exactly) holds the card's bf16
    tolerance against the plain version over the check's grid."""
    for i, (shape, kw) in enumerate(_tc_cases(D)):
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(100 + i, *shape))
        got = _tc_emulation(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        assert torch.isfinite(got).all()
        assert _one_step_misses(got, want) == 0, (shape, kw)


#: query rows per block of the tensor-core kernel (64 a warpgroup)
TC_BQ = 128


@pytest.mark.parametrize("Sk", [37, 1000])
def test_tc_kernel_arithmetic_at_one_query(Sk):
    """Cross attention at decode: one query against Sk keys, non-causal.
    The kernel's block holds 128 query rows; the 127 past Sq are
    zero-filled, attend every key as the real row does, and are never
    stored.  Emulated over the whole block: every row finite, the one
    real row within one bf16 step of the plain version (Sk 1000 ends on
    a partial KV tile of 40 keys)."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(Sk, 2, 8, 2, 1, Sk, 64))
    block = torch.nn.functional.pad(q, (0, 0, 0, TC_BQ - 1))
    got = _tc_emulation(block, k, v, causal=False)
    assert torch.isfinite(got).all()
    want = fa.flash_attention_plain(q, k, v, causal=False)
    assert _one_step_misses(got[:, :, :1], want) == 0


def test_two_term_p_split_misses_the_tolerance():
    """Why three terms: with P_hi + P_lo, p is kept to ~2^-17, and on
    outputs near 0 (where the P V sum cancels) that error passes the
    1e-6 floor of the bf16 check."""
    misses = 0
    for i, (shape, kw) in enumerate(_tc_cases(128)):
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(100 + i, *shape))
        want = fa.flash_attention_plain(q, k, v, **kw)
        misses += _one_step_misses(_tc_emulation(q, k, v, terms=2, **kw),
                                   want)
    assert misses > 0


def test_p_split_terms_add_up_to_p():
    rng = np.random.RandomState(15)
    p = torch.from_numpy(np.exp(-20 * rng.rand(4096)).astype(np.float32))
    hi, mid, lo = _split_terms(p, 3)
    assert torch.equal(hi + mid + lo, p)
    assert all(torch.equal(t, t.to(torch.bfloat16).float())
               for t in (hi, mid, lo))


def test_kernel_choice_is_by_type():
    """bf16 at D 64/128/256 runs the tensor-core kernel; f32 and the
    small head dims the CUDA-core one (f32 never becomes TF32)."""
    for D in fa.HEAD_DIMS:
        tc = fa.kernel_for(torch.bfloat16, D)
        assert tc == ("flash_attention_tc" if D in (64, 128, 256)
                      else "flash_attention")
        assert fa.kernel_for(torch.float32, D) == "flash_attention"


# -- head dims between the built instances: zero-padded along D ---------------

#: (D, padded D): smollm-smoke's head dim and zamba2-7b's
PADDED = [(20, 32), (112, 128)]


@pytest.mark.parametrize("D,Dp", PADDED)
@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0),
                                                    (True, 24, 0),
                                                    (False, None, 0),
                                                    (True, None, 13)])
def test_padded_head_dim_matches_jax(D, Dp, causal, window, q_offset):
    """The wrapper's padding path (on the CPU its plain version runs the
    same padded operands the kernel would get) against the reference's
    Pallas kernel, which takes the head dim as it is, at the reference's
    sweep tolerance; GQA 4 over 2."""
    assert fa.padded_head_dim(D) == Dp
    q, k, v = _inputs(D + q_offset, 2, 4, 2, 37, 50, D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = _jax_flash(q, k, v, 32, 32, **kw)
    got = _port(fa.flash_attention, q, k, v, **kw)
    assert got.shape == want.shape == (2, 4, 37, D)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("D,Dp", PADDED)
def test_padded_head_dim_bf16_within_one_step(D, Dp):
    q, k, v = _inputs(D, 1, 4, 1, 29, 29, D)
    want = _jax_flash(q, k, v, 32, 32, jnp.bfloat16, window=8)
    got = _port(fa.flash_attention, q, k, v, torch.bfloat16, window=8)
    assert np.all(np.abs(got - want) <= BF16_STEP * np.maximum(
        np.abs(got), np.abs(want)) + 1e-6)


@pytest.mark.parametrize("D,Dp", PADDED)
def test_padded_head_dim_keeps_the_callers_scale(D, Dp):
    """1/sqrt(D) of the unpadded D is the right scale: the same call with
    1/sqrt(D_padded) misses the tolerance by far, so a wrapper that took
    the padded D's default would fail the parity test above."""
    q, k, v = _inputs(7, 1, 4, 2, 40, 40, D)
    want = _jax_flash(q, k, v, 32, 32)
    good = _port(fa.flash_attention, q, k, v, scale=D ** -0.5)
    wrong = _port(fa.flash_attention, q, k, v, scale=Dp ** -0.5)
    np.testing.assert_allclose(good, want, rtol=3e-5, atol=3e-5)
    assert np.abs(wrong - want).max() > 100 * 3e-5


def test_plain_version_gets_the_padded_operands(monkeypatch):
    seen = []
    plain = fa.flash_attention_plain

    def spy(q, k, v, **kw):
        seen.append((q.shape[3], k.shape[3], v.shape[3], kw["scale"]))
        assert not q[..., 20:].any() and not v[..., 20:].any()
        return plain(q, k, v, **kw)
    monkeypatch.setattr(fa, "flash_attention_plain", spy)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 1, 5, 5, 20))
    out = fa.flash_attention(q, k, v)
    assert seen == [(32, 32, 32, 20 ** -0.5)]
    assert tuple(out.shape) == (1, 2, 5, 20)


@pytest.mark.parametrize("D,Dp", PADDED)
def test_card_call_launches_the_padded_instance(monkeypatch, D, Dp):
    """A call on the card at D 20 or 112 launches the kernel at the padded
    instance with the caller's scale (``_launch`` stubbed, so that it
    runs without a card), and ``_full_attn`` under ``auto`` never takes
    the chunked oracle for it."""
    launched = []

    def launch(q, k, v, causal, window, q_offset, scale):
        launched.append((tuple(q.shape), tuple(k.shape), scale))
        return torch.zeros(q.shape, dtype=q.dtype)

    def no_oracle(*a, **kw):
        raise AssertionError("routed to chunked_mha")
    monkeypatch.setattr(fa, "_on_card", lambda t: True)
    monkeypatch.setattr(fa, "_launch", launch)
    monkeypatch.setattr(ref, "chunked_mha", no_oracle)
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 2, 8, 2, 9, 9, D))
    out = L._full_attn(q, k, v, api.named_policy("auto"), causal=True,
                       window=None, q_offset=0, scale=D ** -0.5)
    assert launched == [((2, 8, 9, Dp), (2, 2, 9, Dp), D ** -0.5)]
    assert tuple(out.shape) == (2, 8, 9, D)


def test_head_dim_past_256_raises_on_the_card(monkeypatch):
    monkeypatch.setattr(fa, "_on_card", lambda t: True)
    q = torch.zeros((1, 2, 4, 320))
    with pytest.raises(NotImplementedError, match="above the largest"):
        fa.flash_attention(q, q[:, :1], q[:, :1])
    assert fa.padded_head_dim(256) == 256
    assert fa.padded_head_dim(1) == 16
