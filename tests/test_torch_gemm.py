"""repro_torch.api GEMM entries against the JAX package's, on the same
numpy inputs.

The JAX side runs as its own tests run it: ``api.using(backend="pallas",
interpret=True)``, i.e. the Pallas kernel in interpret mode.  The port
runs on the CPU, where the kernel wrapper takes its plain version (the
CUDA kernel itself is checked against that version on the card by
``chip_smoke.py``).  Tolerances are the reference's own ``_RTOL``
(``tests/test_kernels_gemm.py:15``), atol = 10 x rtol as there: both sides
accumulate in f32 (f64 for D) in different orders; H (bf16) outputs may
differ by one bf16 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels import ref as jref
from repro_torch import api, obs
from repro_torch.kernels import iaat_gemm, ref
from repro_torch.models import common

jax.config.update("jax_enable_x64", True)

_RTOL = {"S": 2e-5, "D": 1e-12, "H": 2e-2}
_NP = {"S": np.float32, "D": np.float64, "H": np.float32}
_JNP = {"S": jnp.float32, "D": jnp.float64, "H": jnp.bfloat16}
_TORCH = {"S": torch.float32, "D": torch.float64, "H": torch.bfloat16}
KERNEL = api.Policy(backend="kernel")
AUTO = api.Policy(backend="auto")


def _pair(rng, shape, letter):
    x = rng.randn(*shape).astype(_NP[letter])
    return jnp.asarray(x, _JNP[letter]), torch.from_numpy(x).to(_TORCH[letter])


def _close(got, want, letter):
    tol = _RTOL[letter]
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("letter", ["S", "D", "H"])
@pytest.mark.parametrize("trans", ["NN", "NT", "TN", "TT"])
@pytest.mark.parametrize("policy", [KERNEL, AUTO], ids=["kernel", "auto"])
def test_gemm_matches_jax(letter, trans, policy):
    """All transpositions, K tails (21 and 200 are not multiples of any
    bk), M/N overhangs, alpha/beta with and without C."""
    rng = np.random.RandomState(abs(hash((letter, trans))) % 2**31)
    for (M, N, K, alpha, beta) in ((30, 50, 21, 1.5, 0.5),
                                   (5, 3, 200, 1.0, 0.0)):
        a_shape = (M, K) if trans[0] == "N" else (K, M)
        b_shape = (K, N) if trans[1] == "N" else (N, K)
        ja, ta = _pair(rng, a_shape, letter)
        jb, tb = _pair(rng, b_shape, letter)
        jc, tc = _pair(rng, (M, N), letter) if beta else (None, None)
        ta_, tb_ = trans[0] == "T", trans[1] == "T"
        with japi.using(backend="pallas", interpret=True):
            want = japi.gemm(ja, jb, jc, alpha, beta, ta_, tb_)
        got = api.gemm(ta, tb, tc, alpha, beta, ta_, tb_, policy=policy)
        assert got.dtype == _TORCH[letter] and got.shape == (M, N)
        _close(got, want, letter)


@pytest.mark.parametrize("letter", ["S", "H"])
def test_matmul_nd_reshape_matches_jax(letter):
    """Leading dims flatten into M and come back out."""
    rng = np.random.RandomState(3)
    jx, tx = _pair(rng, (2, 3, 40), letter)
    jw, tw = _pair(rng, (40, 24), letter)
    with japi.using(backend="pallas", interpret=True):
        want = japi.matmul(jx, jw)
    for pol in (KERNEL, AUTO):
        got = api.matmul(tx, tw, policy=pol)
        assert got.shape == (2, 3, 24)
        _close(got, want, letter)


def test_matmul_tied_transposed_weight():
    """A (K, N) weight that is the .T view of an (N, K) embedding — the
    tied unembed — gives the reference's result."""
    rng = np.random.RandomState(4)
    jx, tx = _pair(rng, (4, 64), "S")
    je, te = _pair(rng, (300, 64), "S")
    with japi.using(backend="pallas", interpret=True):
        want = japi.matmul(jx, je.T)
    got = api.matmul(tx, te.T, policy=KERNEL)
    _close(got, want, "S")


def test_router_precedence_forced_over_analytical():
    obs.reset()
    big, small = (2048, 2048, 2048), (4, 2048, 2048)
    assert not api.small_enough(*big, policy=AUTO)
    assert api.small_enough(*small, policy=AUTO)
    d = api.route("gemm", big, "S", policy=KERNEL)
    assert (d.use_kernel, d.source) == (True, "forced")
    d = api.route("gemm", big, "S", policy=AUTO)
    assert (d.use_kernel, d.source) == (False, "analytical")
    d = api.route("gemm", small, "S", policy=api.Policy(backend="library"))
    assert (d.use_kernel, d.source) == (False, "forced")
    d = api.route("gemm", (100, 100, 100), "S",
                  policy=AUTO.replace(paper_thresholds=True))
    assert (d.use_kernel, d.source) == (False, "analytical")
    # matmul dims (*lead, K, N): M = prod(lead)
    d = api.route("matmul", (2, 2, 2048, 2048), "H", policy=AUTO)
    assert (d.use_kernel, d.source) == (True, "analytical")
    # the shape log memoizes: a repeat is a hit on the same entry
    api.route("gemm", big, "S", policy=KERNEL)
    assert obs.ROUTES.total >= 6
    assert obs.ROUTES.kernel_share()[0] >= 2


def test_hopper_crossover_is_the_bf16_ridge():
    """The unmeasured Hopper prior: 4 x (989e12 / 3.35e12) ~ 1181."""
    assert api.HOPPER_CROSSOVER == pytest.approx(4 * 989e12 / 3.35e12)
    assert AUTO.threshold("NN") == pytest.approx(api.HOPPER_CROSSOVER)
    assert AUTO.threshold("TN") == pytest.approx(32 * api.HOPPER_SCALE)


def test_tuned_and_complex_kernel_paths_raise():
    """The tuned backend and the complex kernel path answer now; what
    still raises is what the reference refuses too: a gradient through a
    complex region (forward-only)."""
    pol = api.named_policy("tuned")
    assert pol.backend == "tuned"
    a = torch.randn(4, 4, dtype=torch.complex64)
    want = ref.ref_gemm(a, a).numpy()
    for p in (KERNEL, pol, api.Policy(backend="library")):
        np.testing.assert_allclose(api.gemm(a, a, policy=p).numpy(), want,
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="forward-only"):
        api.gemm(a.clone().requires_grad_(), a, policy=KERNEL)


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    iaat_gemm.reset_launch_count()
    x = torch.randn(4, 64)
    api.matmul(x, torch.randn(64, 128), policy=KERNEL)
    assert iaat_gemm.launch_count() == 0


@pytest.mark.parametrize("letter,trans", [("S", "NN"), ("S", "TT"),
                                          ("D", "NT"), ("D", "TN")])
def test_grads_match_jax_grad(letter, trans):
    """The autograd Function's backward (the two adjoint GEMMs, plus
    beta*dC) against jax.grad through the reference's custom VJP, on a
    multi-region plan."""
    rng = np.random.RandomState(5)
    M, N, K, alpha, beta = 20, 140, 33, 1.25, -0.5
    a_shape = (M, K) if trans[0] == "N" else (K, M)
    b_shape = (K, N) if trans[1] == "N" else (N, K)
    ja, ta = _pair(rng, a_shape, letter)
    jb, tb = _pair(rng, b_shape, letter)
    jc, tc = _pair(rng, (M, N), letter)
    jg, tg = _pair(rng, (M, N), letter)
    ta_, tb_ = trans[0] == "T", trans[1] == "T"

    def jloss(a, b, c):
        return jnp.sum(japi.gemm(a, b, c, alpha, beta, ta_, tb_) * jg)

    with japi.using(backend="pallas", interpret=True):
        jgrads = jax.grad(jloss, argnums=(0, 1, 2))(ja, jb, jc)
    ts = [t.clone().requires_grad_(True) for t in (ta, tb, tc)]
    out = api.gemm(*ts, alpha, beta, ta_, tb_, policy=KERNEL)
    (out * tg).sum().backward()
    # the reference takes its adjoints in f32 (it casts dC to f32 even
    # for D), so D is held at the S tolerance here
    tol = _RTOL["S"]
    for t, jgr in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.double().numpy(),
                                   np.asarray(jgr, np.float64),
                                   rtol=tol, atol=tol * 10)


def test_obs_span_route_memo_and_trace():
    """The observability the Router and the engine touch: a span records
    its dotted-path histogram; a repeat route() is a memo hit on the same
    entry; a memo miss lands in the flight recorder; unknown events are
    rejected."""
    obs.reset()
    with obs.span("outer"):
        with obs.span("inner"):
            pass
    assert obs.REGISTRY.get("span.outer.inner_us").count == 1
    assert obs.REGISTRY.get("span.outer_us").count == 1
    d1 = api.route("gemm", (8, 64, 64), "S", policy=AUTO)
    d2 = api.route("gemm", (8, 64, 64), "S", policy=AUTO)
    assert d1 is d2 and obs.ROUTES.total == 2
    assert [e[1] for e in obs.TRACE.snapshot()] == ["ROUTE_MISS"]
    with pytest.raises(ValueError):
        obs.TRACE.emit("NOT_AN_EVENT")
    h = obs.histogram("lat")
    for v in (1.0, 2.0, 4.0, 8.0):
        h.record(v)
    assert h.percentile(0) == 1.0 and h.percentile(100) == 8.0
    assert 1.0 <= h.p50 <= 8.0


def test_long_plan_routes_to_library_under_auto(monkeypatch):
    """Under auto a plan longer than MAX_PLAN_REGIONS goes to the library
    and the route log records it so; the forced-kernel policy still runs
    the plan.  Fresh Policy objects keep the memo of this test apart."""
    monkeypatch.setattr(api, "MAX_PLAN_REGIONS", 0)
    auto, kernel = api.Policy(backend="auto"), api.Policy(backend="kernel")
    obs.reset()
    d = api.route("gemm", (30, 50, 21), "S", policy=auto)
    assert (d.use_kernel, d.source) == (False, "analytical")
    d = api.route("gemm", (30, 50, 21), "S", policy=kernel)
    assert (d.use_kernel, d.source) == (True, "forced")
    assert obs.ROUTES.kernel_share() == (1, 2)
    rng = np.random.RandomState(7)
    a = torch.from_numpy(rng.randn(30, 21).astype(np.float32))
    b = torch.from_numpy(rng.randn(21, 50).astype(np.float32))
    want = ref.ref_gemm(a, b).numpy()
    for pol in (auto, kernel):
        np.testing.assert_allclose(api.gemm(a, b, policy=pol).numpy(), want,
                                   rtol=_RTOL["S"], atol=_RTOL["S"] * 10)
    obs.reset()


def test_install_turns_tf32_off(monkeypatch):
    """The library path widens operands to f32, so install() turns TF32
    off once for the process."""
    monkeypatch.setattr(api, "_DEFAULT", api._DEFAULT)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        api.install(api.Policy(backend="auto"))
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("letter", ["S", "D", "H"])
def test_ref_oracles_match_jax_ref(letter):
    """The port's oracles against the reference's on the same inputs, at
    the reference _RTOL; the model's rmsnorm against the port's oracle
    (both f32 inside, one cast: bitwise on the CPU)."""
    rng = np.random.RandomState(6)
    ja, ta = _pair(rng, (21, 12), letter)
    jb, tb = _pair(rng, (9, 21), letter)
    jc, tc = _pair(rng, (12, 9), letter)
    want = jref.ref_gemm(ja, jb, jc, 1.5, -0.5, trans_a=True, trans_b=True)
    got = ref.ref_gemm(ta, tb, tc, 1.5, -0.5, trans_a=True, trans_b=True)
    assert got.dtype == _TORCH[letter]
    _close(got, want, letter)
    jx, tx = _pair(rng, (3, 16), letter)
    jw, tw = _pair(rng, (16,), letter)
    got = ref.ref_rmsnorm(tx, tw)
    # rmsnorm computes in f32 for every dtype (D too), and XLA's rsqrt and
    # torch's differ in the last f32 bit: so D is held at the S tolerance
    _close(got, jref.ref_rmsnorm(jx, jw), "S" if letter == "D" else letter)
    assert torch.equal(common.rmsnorm(tx, tw, 1e-6), got)
