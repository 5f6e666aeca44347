"""GEMMs whose operands differ in dtype, through ``repro_torch.api.gemm``,
against numpy (in f64 / complex128).

The rule (the reference's ``_cx_call`` and ``tests/test_api.py``'s
epilogue test): a and b are brought to their promoted type before the
plan's regions run, so a real x complex GEMM takes the complex kernel with
a zero imaginary plane; a ``c`` of any dtype enters at the accumulator's
precision (``iaat_gemm.c_dtype``), and the result takes the promoted type
of a and b.  numpy is the yardstick, not the reference's ``xla`` path,
which drops the imaginary part of a real x complex product.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import kernelgen
from repro_torch.kernels import iaat_gemm

POLICIES = ["auto", "kernel", "library"]


def _gemm(a, b, c=None, alpha=1.0, beta=0.0, policy="auto"):
    return api.gemm(torch.from_numpy(a), torch.from_numpy(b),
                    None if c is None else torch.from_numpy(c), alpha, beta,
                    policy=api.Policy(backend=policy))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("real,cplx,rtol", [(np.float32, np.complex64, 2e-6),
                                            (np.float64, np.complex128,
                                             1e-12)])
@pytest.mark.parametrize("real_first", [True, False])
def test_real_times_complex(policy, real, cplx, rtol, real_first):
    """f32 x c64 and f64 x c128 (either operand real), 8 x 8, with alpha
    and a complex c: the result is complex, with the imaginary part."""
    rng = np.random.RandomState(0)
    r = rng.randn(8, 8).astype(real)
    z = (rng.randn(8, 8) + 1j * rng.randn(8, 8)).astype(cplx)
    c = (rng.randn(8, 8) + 1j * rng.randn(8, 8)).astype(cplx)
    a, b = (r, z) if real_first else (z, r)
    out = _gemm(a, b, c, alpha=1.5, beta=-0.5, policy=policy)
    assert out.dtype == torch.from_numpy(z).dtype
    want = 1.5 * (a.astype(np.complex128) @ b.astype(np.complex128)) \
        - 0.5 * c.astype(np.complex128)
    np.testing.assert_allclose(out.numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())
    assert np.abs(out.numpy().imag).max() > 0.1


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("c_dtype", [torch.bfloat16, torch.float64])
def test_single_with_c_of_another_dtype(policy, c_dtype):
    """An S GEMM with a bf16 or f64 c: f32 out, c entering in f32."""
    rng = np.random.RandomState(1)
    a = rng.randn(16, 12).astype(np.float32)
    b = rng.randn(12, 20).astype(np.float32)
    c = torch.from_numpy(rng.randn(16, 20)).to(c_dtype)
    out = api.gemm(torch.from_numpy(a), torch.from_numpy(b), c, 1.5, 0.3,
                   policy=api.Policy(backend=policy))
    assert out.dtype == torch.float32
    want = 1.5 * a.astype(np.float64) @ b.astype(np.float64) \
        + 0.3 * c.float().double().numpy()
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("policy", POLICIES)
def test_half_with_f32_c_is_never_rounded_through_bf16(policy):
    """An H GEMM with an f32 c whose value bf16 cannot hold: 1 + 2^-10.
    op(A) op(B) = -1024 exactly and beta * c = 1025 in f32, so the bf16
    result is 1.0; had c been rounded to bf16 first (to 1.0), it would be
    0.0."""
    a = torch.full((4, 1), -32.0).bfloat16()
    b = torch.full((1, 24), 32.0).bfloat16()
    c = torch.full((4, 24), 1.0 + 2.0 ** -10)
    out = api.gemm(a, b, c, 1.0, 1024.0, policy=api.Policy(backend=policy))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, torch.ones((4, 24), dtype=torch.bfloat16))


def test_region_casts_c_to_the_accumulator():
    """One region of each real letter takes c in its accumulator type and
    returns the letter's dtype; a complex region takes a real c as complex."""
    for letter, acc in (("S", torch.float32), ("D", torch.float64),
                        ("H", torch.float32), ("C", torch.complex64),
                        ("Z", torch.complex128)):
        sig = kernelgen.kernel_table(letter, "NN")[0]
        assert iaat_gemm.c_dtype(sig) == acc
        a = torch.ones((3, 5), dtype=sig.dtype)
        b = torch.ones((5, 7), dtype=sig.dtype)
        c = torch.full((3, 7), 2.0, dtype=torch.float64)
        out = iaat_gemm.gemm_region(sig, a, b, c, alpha=1.0, beta=0.5)
        assert out.dtype == sig.dtype
        assert torch.equal(out, torch.full((3, 7), 6.0, dtype=sig.dtype))
