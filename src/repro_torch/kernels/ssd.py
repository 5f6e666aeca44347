"""Mamba-2 SSD (state-space duality) chunked scan on Hopper.

Counterpart of ``repro/kernels/ssd.py``: x (Bt, S, H, P), dt (Bt, S, H),
A (H,), B and C (Bt, S, 1, N) shared by every head -> y (Bt, S, H, P) in
x's dtype.  The D skip is the caller's.  Per chunk of ``chunk`` tokens:
the cumsum of dt*A, the intra-chunk (C Bᵀ ⊙ L ⊙ dt) @ x, the inter-chunk
exp(cum) (C @ h), and the state update h <- exp(total) h + wᵀ @ x with
w = dt exp(total - cum) B; rows past S are masked (dt = 0 there).

* On a CUDA tensor :func:`ssd_scan` launches the hand-written CUDA
  kernels (``csrc/ssd.cu``, built by ``kernels/build.py``) or raises;
  there is no fallback.  A scan is three launches, the chunks in parallel
  (:func:`launch_plan`): each chunk's own state, the state pass over the
  chunks, and the chunks' outputs with C Bᵀ formed once for a group of
  heads; a scan of one chunk is the last alone.  Each launch is checked
  with ``cudaGetLastError``; the C entry reports the kernels it queued,
  which :func:`launch_count` adds up, and :func:`scan_count` counts the
  scans.  The kernels read x, dt, B
  and C through their strides, so the model's views cut from the conv
  output reach them uncopied.
* On a CPU tensor it runs :func:`ssd_scan_plain`, the plain PyTorch
  version of the same per-chunk arithmetic, in f32, chunk after chunk.

The instances are ``chunk`` in :data:`CHUNKS` and x, B, C in f32 or bf16
(dt and A in f32), with N a multiple of 4 up to :data:`N_MAX` and P a
multiple of 4 up to :data:`P_MAX` (held :func:`padded` wide on the card);
the wrapper raises for anything else on every device.  There is no backward, as in the reference: a call that
autograd would record raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import vmem
from repro_torch.kernels.iaat_gemm import records_grad

#: chunk lengths the CUDA kernel is instantiated for
CHUNKS = (16, 32, 64, 128)
#: the largest state and head widths one block's shared memory holds
#: (204,288 B at chunk 128, N 128, P 64; DESIGN_PORT.md §10)
N_MAX, P_MAX = 128, 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the most blocks a CUDA grid takes along y and z
_GRID_YZ_MAX = 65535
#: threads of a block, and floats of padding on a staged row (csrc/ssd.cu)
_NT, _PAD = 256, 4

_launches = 0
_scans = 0


def launch_count() -> int:
    """CUDA kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def scan_count() -> int:
    """Scans that launched since the last :func:`reset_launch_count`."""
    return _scans


def reset_launch_count() -> None:
    global _launches, _scans
    _launches = _scans = 0


def padded(P: int) -> int:
    """The width the kernels hold x, h and the chunk states at: P rounded
    up to 8, the columns past P zero (csrc/ssd.cu ``padded``)."""
    return -(-P // 8) * 8


def state_smem_bytes(chunk: int, N: int, P: int) -> int:
    """Shared bytes of a block of the state kernel: B, x and three chunk
    vectors (csrc/ssd.cu ``state_floats``)."""
    return 4 * (chunk * (N + _PAD) + chunk * padded(P) + 3 * chunk)


def out_smem_bytes(chunk: int, N: int, P: int) -> int:
    """Shared bytes of a block of the output kernel: C, a region for B
    and then x and h, the scores and three chunk vectors (csrc/ssd.cu
    ``out_floats``)."""
    region = max(chunk * (N + _PAD), (chunk + N) * padded(P))
    return 4 * (chunk * (N + _PAD) + region + chunk * (chunk + _PAD)
                + 3 * chunk)


def _resident(smem: int) -> int:
    """Blocks of ``smem`` shared bytes an SM holds, at most two (the
    kernels' register budget)."""
    return max(1, min(2, vmem.SMEM_SM_BYTES //
                      (smem + vmem.SMEM_BLOCK_RESERVED)))


def heads_per_block(H: int, blocks: int, resident: int) -> int:
    """The heads a block takes, ``hg``, for a grid of ``blocks`` x
    (H / hg) blocks of which the card holds :data:`vmem.NUM_SMS` x
    ``resident`` at once: the divisor of H whose grid, counted in such
    waves times the hg heads each block walks, takes the least time; the
    larger hg on a tie (fewer stagings of B, fewer C Bᵀ)."""
    best = None
    for hg in range(1, H + 1):
        if H % hg:
            continue
        waves = -(-blocks * (H // hg) // (vmem.NUM_SMS * resident))
        cost = waves * hg
        if best is None or cost <= best[0]:
            best = (cost, hg)
    return best[1]


def launch_plan(Bt: int, S: int, H: int, N: int, P: int, chunk: int):
    """(chunks, hg1, hg3) of one scan on the card: the state kernel's
    grid is (chunks - 1) x (H / hg1) x Bt, the output kernel's chunks x
    (H / hg3) x Bt; when S fits one chunk the output kernel runs alone
    (hg1 is then 0)."""
    nc = -(-S // chunk)
    hg3 = heads_per_block(H, nc * Bt, _resident(out_smem_bytes(chunk, N, P)))
    if nc == 1:
        return nc, 0, hg3
    hg1 = heads_per_block(H, (nc - 1) * Bt,
                          _resident(state_smem_bytes(chunk, N, P)))
    return nc, hg1, hg3


def launches_per_scan(S: int, chunk: int) -> int:
    """CUDA launches one scan over S tokens (S > 0) should make: the
    state kernel, the state pass and the output kernel, or the output
    kernel alone.  A prediction for checks to hold :func:`launch_count`
    against; the count itself is what the C entry reports."""
    return 1 if S <= chunk else 3


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 128):
    """Plain PyTorch version of the kernel: the reference ``_body``'s
    per-chunk arithmetic, in f32, batched over (Bt, H), chunk after chunk,
    with the state carried as (N, P) per head.  ``L`` is formed with
    ``torch.where`` on the lower triangle, never as a product with a 0/1
    mask: exp(cum_t - cum_s) overflows to inf above the diagonal."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    dev = x.device
    A = A.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev))[None, :, :, None]
    zero = torch.zeros((), device=dev)
    h = torch.zeros((Bt, H, N, P), dtype=torch.float32, device=dev)
    y = torch.empty((Bt, S, H, P), dtype=x.dtype, device=dev)
    for c0 in range(0, S, chunk):
        n = min(chunk, S - c0)
        pad = chunk - n

        def cut(t, dims):
            t = t[:, c0:c0 + n].float()
            return torch.nn.functional.pad(t, (0, 0) * dims + (0, pad))

        xc = cut(x, 2)                                    # (Bt, c, H, P)
        dtc = cut(dt, 1)                                  # (Bt, c, H)
        Bc, Cc = cut(B[:, :, 0], 1), cut(C[:, :, 0], 1)   # (Bt, c, N)
        cum = torch.cumsum(dtc * A, dim=1)                # inclusive
        total = cum[:, -1]                                # (Bt, H)
        diff = cum[:, :, None, :] - cum[:, None, :, :]    # (Bt, t, s, H)
        L = torch.where(tri, torch.exp(diff), zero)
        cb = torch.einsum("btn,bsn->bts", Cc, Bc)
        scores = cb[..., None] * L * dtc[:, None]         # (Bt, t, s, H)
        yc = torch.einsum("btsh,bshp->bthp", scores, xc)
        yc = yc + torch.exp(cum)[..., None] * torch.einsum(
            "btn,bhnp->bthp", Cc, h)
        w = (dtc * torch.exp(total[:, None] - cum))[..., None] \
            * Bc[:, :, None, :]                           # (Bt, c, H, N)
        h = torch.exp(total)[..., None, None] * h + torch.einsum(
            "bchn,bchp->bhnp", w, xc)
        y[:, c0:c0 + n] = yc[:, :n].to(x.dtype)
    return y


def _check(x, dt, A, B, C, chunk):
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or B.ndim != 4 or \
            C.ndim != 4:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)} are not "
                         "(Bt, S, H, P), (Bt, S, H), (H,), (Bt, S, 1, N) x2")
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    if tuple(dt.shape) != (Bt, S, H) or tuple(A.shape) != (H,) or \
            tuple(B.shape) != (Bt, S, 1, N) or tuple(C.shape) != (Bt, S, 1, N):
        raise ValueError(f"ssd_scan: shapes disagree: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)} (B and C "
                         "are shared by every head: G = 1)")
    if chunk not in CHUNKS:
        raise NotImplementedError(f"ssd_scan: no kernel for chunk {chunk} "
                                  f"(built: {CHUNKS})")
    if not (0 < N <= N_MAX and N % 4 == 0 and 0 < P <= P_MAX
            and P % 4 == 0):
        raise NotImplementedError(
            f"ssd_scan: no kernel for N={N}, P={P} (multiples of 4, N <= "
            f"{N_MAX}, P <= {P_MAX})")
    for name, t in (("B", B), ("C", C)):
        if t.dtype != x.dtype:
            raise TypeError(f"ssd_scan: {name} is {t.dtype}, x is "
                            f"{x.dtype}; the kernel takes one dtype")
    if x.dtype not in _DTYPE_CODE:
        raise NotImplementedError(f"ssd_scan: no kernel for {x.dtype} "
                                  "(f32 and bf16 only)")
    for name, t in (("dt", dt), ("A", A)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} is {t.dtype}, want float32")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} on {t.device}, x on "
                             f"{x.device}")
    if records_grad(x, dt, A, B, C):
        raise NotImplementedError("ssd_scan: no backward (as in the "
                                  "reference); call under torch.no_grad()")


def _strides(t, dims):
    st = t.stride()
    return (ctypes.c_longlong * len(dims))(*(st[d] for d in dims))


def _launch(x, dt, A, B, C, chunk):
    global _launches, _scans
    from repro_torch.kernels import build
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    y = torch.empty((Bt, S, H, P), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    nc, hg1, hg3 = launch_plan(Bt, S, H, N, P, chunk)
    if Bt > _GRID_YZ_MAX or H > _GRID_YZ_MAX:
        raise ValueError(f"ssd_scan: Bt={Bt}, H={H} exceed the CUDA grid")
    A = A.contiguous()
    # the chunk states and exp(total) of each (batch, chunk, head), from
    # the caching allocator; held until the launches are queued, the
    # stream orders any reuse
    scratch = None if nc == 1 else torch.empty(
        Bt * nc * H * (N * padded(P) + 1), dtype=torch.float32,
        device=x.device)
    launched = ctypes.c_int(0)
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan(
            _DTYPE_CODE[x.dtype], chunk,
            x.data_ptr(), _strides(x, (0, 1, 2, 3)),
            dt.data_ptr(), _strides(dt, (0, 1, 2)), A.data_ptr(),
            B.data_ptr(), _strides(B, (0, 1, 3)),
            C.data_ptr(), _strides(C, (0, 1, 3)),
            y.data_ptr(), _strides(y, (0, 1, 2, 3)),
            Bt, S, H, N, P, hg1, hg3,
            None if scratch is None else scratch.data_ptr(), stream,
            ctypes.pointer(launched))
    _launches += launched.value
    if rc == -1:
        raise RuntimeError(f"ssd_scan: ({x.dtype}, chunk {chunk}) is not an "
                           "instance of the built kernel")
    if rc:
        msg = lib.iaat_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan: launch failed: {msg}")
    _scans += 1
    return y


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """x: (Bt, S, H, P); dt: (Bt, S, H) f32; A: (H,) f32; B, C:
    (Bt, S, 1, N).  Returns y: (Bt, S, H, P) in x's dtype, without the D
    skip.  S need not be a multiple of ``chunk``.  Operands may be any
    strided views: the CUDA kernel reads them through their strides, and
    makes no copy."""
    _check(x, dt, A, B, C, chunk)
    if x.device.type == "cuda":
        return _launch(x, dt, A, B, C, chunk)
    if x.device.type != "cpu":
        raise ValueError(f"no SSD kernel for device {x.device}")
    return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
