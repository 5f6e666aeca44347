"""The port's Mamba-2 SSD scan and its oracles against the JAX package's.

On the CPU ``kernels/ssd.py::ssd_scan`` runs its plain version; it is held
against the reference's Pallas kernel in interpret mode
(``repro.kernels.ops.ssd_scan(..., interpret=True)``) and against the
ground-truth recurrence, at the reference's own tolerances (rtol 1e-4,
atol 1e-5; ``tests/test_kernels_other.py``).  Inputs are made from a seed
with numpy and handed to both packages.  The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import ref, ssd

RTOL, ATOL = 1e-4, 1e-5


def _inputs(rng, Bt, S, H, P, N):
    """The reference tests' SSD inputs (``_ssd_inputs``), as numpy."""
    x = (rng.randn(Bt, S, H, P) * 0.3).astype(np.float32)
    dt = (np.abs(rng.randn(Bt, S, H)) * 0.1 + 0.01).astype(np.float32)
    A = (-np.abs(rng.randn(H)) * 0.5 - 0.1).astype(np.float32)
    B = (rng.randn(Bt, S, 1, N) * 0.3).astype(np.float32)
    C = (rng.randn(Bt, S, 1, N) * 0.3).astype(np.float32)
    return x, dt, A, B, C


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("Bt", [1, 2, 3])
@pytest.mark.parametrize("S", [17, 64, 100])
@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_scan_matches_pallas_interpret(Bt, S, chunk):
    """The reference's shape sweep (``test_ssd_kernel_shape_sweep``):
    H 2, P 8, N 16, S not always a multiple of the chunk."""
    a = _inputs(np.random.RandomState(Bt * 31 + S), Bt, S, 2, 8, 16)
    got = ssd.ssd_scan(*_t(a), chunk=chunk).numpy()
    want = np.asarray(jops.ssd_scan(*_j(a), chunk=chunk, interpret=True))
    gt = np.asarray(jref.ref_ssd_recurrent(*_j(a)))
    assert got.shape == (Bt, S, 2, 8)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, gt, rtol=RTOL, atol=ATOL)


def test_ssd_scan_wider_heads_vs_recurrent():
    """``test_ssd_kernel_vs_recurrent``'s shape: H 3, P 16, N 24."""
    a = _inputs(np.random.RandomState(5), 2, 96, 3, 16, 24)
    got = ssd.ssd_scan(*_t(a), chunk=32).numpy()
    gt = ref.ref_ssd_recurrent(*_t(a)).numpy()
    np.testing.assert_allclose(got, gt, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(jref.ref_ssd_recurrent(*_j(a))), rtol=RTOL,
        atol=ATOL)


def test_ssd_scan_reads_strided_views():
    """x, B and C cut from one conv row, as ``ssm.mamba`` passes them."""
    rng = np.random.RandomState(7)
    Bt, S, H, P, N = 2, 40, 2, 8, 16
    row = (rng.randn(Bt, S, H * P + 2 * N) * 0.3).astype(np.float32)
    _, dt, A, _, _ = _inputs(rng, Bt, S, H, P, N)
    co = torch.from_numpy(row)
    x = co[..., :H * P].reshape(Bt, S, H, P)
    B = co[..., H * P:H * P + N].reshape(Bt, S, 1, N)
    C = co[..., H * P + N:].reshape(Bt, S, 1, N)
    assert not x.is_contiguous() and not B.is_contiguous()
    got = ssd.ssd_scan(x, torch.from_numpy(dt), torch.from_numpy(A), B, C,
                       chunk=16)
    want = ssd.ssd_scan(x.contiguous(), torch.from_numpy(dt),
                        torch.from_numpy(A), B.contiguous(), C.contiguous(),
                        chunk=16)
    assert torch.equal(got, want)


def test_ssd_scan_bf16_output_dtype():
    """bf16 x, B, C: y in bf16, within one bf16 rounding (2^-8 relative)
    of the f32 scan of the same (rounded) inputs."""
    a = _inputs(np.random.RandomState(8), 1, 50, 2, 8, 16)
    x, dt, A, B, C = _t(a)
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, B, C))
    got = ssd.ssd_scan(xb, dt, A, Bb, Cb, chunk=16)
    want = ssd.ssd_scan(xb.float(), dt, A, Bb.float(), Cb.float(), chunk=16)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max() <= \
        2.0 ** -8 * want.abs().max() + 1e-6


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_ref_ssd_matches_reference(chunk):
    """The port's chunked oracle (the model's library path, with the D
    skip) against the reference's ``ref_ssd`` and both recurrences."""
    rng = np.random.RandomState(4)
    a = _inputs(rng, 2, 96, 3, 16, 24)
    D = rng.rand(3).astype(np.float32)
    got = ref.ref_ssd(*_t(a), D_skip=torch.from_numpy(D), chunk=chunk)
    want = jref.ref_ssd(*_j(a), D_skip=jnp.asarray(D), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    gt = ref.ref_ssd_recurrent(*_t(a), D_skip=torch.from_numpy(D))
    np.testing.assert_allclose(
        gt.numpy(), np.asarray(jref.ref_ssd_recurrent(
            *_j(a), D_skip=jnp.asarray(D))), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), gt.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_ssd_state_handoff():
    """Chunked-with-state then one decode step == the recurrence, on both
    packages (``test_ssd_state_handoff``): the final state of ``ref_ssd``
    and the decode step's new state agree with the reference's."""
    a = _inputs(np.random.RandomState(6), 1, 33, 2, 8, 16)
    x, dt, A, B, C = _t(a)
    y, h = ref.ref_ssd(x[:, :32], dt[:, :32], A, B[:, :32], C[:, :32],
                       chunk=16, return_state=True)
    h2, y2 = ref.ref_ssd_decode_step(h, x[:, 32].float(), dt[:, 32], A,
                                     B[:, 32, 0], C[:, 32, 0])
    gt = ref.ref_ssd_recurrent(x, dt, A, B, C)
    np.testing.assert_allclose(y2.numpy(), gt[:, 32].numpy(), rtol=RTOL,
                               atol=ATOL)
    jx, jdt, jA, jB, jC = _j(a)
    jy, jh = jref.ref_ssd(jx[:, :32], jdt[:, :32], jA, jB[:, :32],
                          jC[:, :32], chunk=16, return_state=True)
    jh2, jy2 = jref.ref_ssd_decode_step(jh, jx[:, 32], jdt[:, 32], jA,
                                        jB[:, 32, 0], jC[:, 32, 0])
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(h2.numpy(), np.asarray(jh2), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)


def test_ssd_scan_finite_where_decay_overflows_above_diagonal():
    """Decays so steep that exp(cum_t - cum_s) overflows f32 for s > t
    (|dt A| summed over a chunk far past 88): the scan stays finite and
    equal to the recurrence, because L is selected, never multiplied by a
    0/1 mask (inf * 0 = NaN)."""
    rng = np.random.RandomState(9)
    x, dt, A, B, C = _inputs(rng, 1, 48, 2, 8, 16)
    dt = np.full_like(dt, 2.0)
    A = np.array([-30.0, -5.0], np.float32)
    diff = np.cumsum(dt[0, :16, 0] * A[0])
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(np.float32(diff[0] - diff[-1])))
    a = (x, dt, A, B, C)
    got = ssd.ssd_scan(*_t(a), chunk=16)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(),
                               ref.ref_ssd_recurrent(*_t(a)).numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.ssd_scan(*_j(a), chunk=16,
                                              interpret=True)),
        rtol=RTOL, atol=ATOL)


def test_ssd_scan_refuses_autograd():
    """No backward, as in the reference: a call autograd would record
    raises, on the CPU as on the card."""
    x, dt, A, B, C = _t(_inputs(np.random.RandomState(1), 1, 16, 2, 8, 16))
    x.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        ssd.ssd_scan(x, dt, A, B, C, chunk=16)
    with torch.no_grad():
        assert ssd.ssd_scan(x, dt, A, B, C, chunk=16).shape == x.shape


@pytest.mark.parametrize("case", ["chunk", "N", "P", "dtype", "groups"])
def test_ssd_scan_refuses_shapes_outside_the_instances(case):
    """Every device refuses what the CUDA kernel has no instance for."""
    rng = np.random.RandomState(2)
    Bt, S, H, P, N = 1, 20, 2, 8, 16
    chunk = 16
    if case == "N":
        N = 130
    if case == "P":
        P = 6
    a = _t(_inputs(rng, Bt, S, H, P, N))
    if case == "chunk":
        chunk = 24
    if case == "dtype":
        a[0] = a[0].double()
    if case == "groups":
        a[3] = a[3].expand(Bt, S, 2, N)
    with pytest.raises((NotImplementedError, TypeError, ValueError)):
        ssd.ssd_scan(*a, chunk=chunk)


def test_ssd_launch_count_untouched_on_cpu():
    """The count is of CUDA launches: the plain version adds nothing."""
    ssd.reset_launch_count()
    ssd.ssd_scan(*_t(_inputs(np.random.RandomState(3), 1, 20, 2, 8, 16)),
                 chunk=16)
    assert ssd.launch_count() == 0

