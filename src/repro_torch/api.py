"""One routing API: ``Policy`` + ``Router`` for every GEMM shape (port).

Counterpart of ``repro/api.py``.  The paper's thesis is that one
input-aware decision layer picks the kernel for every small GEMM:

* :class:`Policy` — one frozen routing config; one ambient policy
  (:func:`install` / :func:`using`) and a per-call ``policy=`` override.
* :class:`Router` — ``route(op, dims, dtype) -> Decision`` for ``gemm``
  (2-D BLAS) and ``matmul`` (ND, leading dims flatten into M).  The
  grouped ops (``batched_gemm``, ``ragged_gemm``) are not ported yet.

Decision precedence:  forced (backend="kernel"/"library")  >  profile
(backend="tuned", not ported: raises)  >  analytical (smallness).

Executors (:func:`gemm`, :func:`matmul`) act on the Decision: the kernel
path runs the plan through the hand-written CUDA kernel
(``kernels/iaat_gemm.py``), the library path runs ``torch.matmul`` in the
accumulator dtype (the ``_xla_gemm`` epilogue rule), with TF32 off from
:func:`install` on.
Every ``route`` call lands in :data:`repro_torch.obs.ROUTES`.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core import (cost, kernelgen, paper_table, plan as plan_mod,
                              templates)

#: Cube edge at which a bf16 GEMM on an H100 turns from bytes-bound to
#: operations-bound: a cube n^3 moves 8n^2 bytes for 2n^3 flops, so its
#: intensity n/4 meets the ridge (989 TFLOP/s / 3.35 TB/s = 295) at
#: n = 4 * 295 = 1181.  Below it a no-pack kernel and the library move the
#: same bytes and the library's tensor-core advantage idles, so the small
#: regime extends to about there.  An UNMEASURED PRIOR (DESIGN_PORT.md §4)
#: until the port's tuner measures the crossover on the card.
HOPPER_CROSSOVER = 4.0 * cost.RIDGE_BF16
#: The paper's 80/32 thresholds scaled to that crossover (~14.8).
HOPPER_SCALE = HOPPER_CROSSOVER / paper_table.PAPER_SMALL_THRESHOLD

#: The most regions (one kernel launch each) a plan may have and still
#: count as the small regime.  Under ``auto`` a longer plan routes to the
#: library, and ``ROUTES`` records it so; the forced-kernel policy runs
#: every plan through the kernel, however long (the reference's valve).
MAX_PLAN_REGIONS = 64

#: Op kinds the router understands, with their ``dims`` convention:
#:   gemm          (M, N, K)            2-D BLAS entry
#:   matmul        (*lead, K, N)        x.shape + (N,); M = prod(lead)
OPS = ("gemm", "matmul")
BACKENDS = ("kernel", "library", "auto", "tuned")


@dataclasses.dataclass(frozen=True)
class Policy:
    """The single routing policy every GEMM-shaped op consults.

    ``backend``: ``kernel`` forces the IAAT kernel, ``library`` forces
    ``torch.matmul``, ``auto`` applies the analytical criterion, ``tuned``
    (route by a measured profile) raises until ``tune/`` is ported.
    ``iaat=False`` sends model matmuls straight to ``torch.matmul``.
    """
    backend: str = "auto"
    paper_thresholds: bool = False  # use the ARMv8 80/32 bounds verbatim
    iaat: bool = True

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected "
                             f"one of {BACKENDS}")
        if self.backend == "tuned":
            raise NotImplementedError(
                "backend='tuned' needs the port of repro.tune (measured "
                "device profiles); use 'auto' or 'kernel'")

    def threshold(self, trans: str) -> float:
        base = (paper_table.PAPER_SMALL_THRESHOLD_TN if trans == "TN"
                else paper_table.PAPER_SMALL_THRESHOLD)
        return base if self.paper_thresholds else base * HOPPER_SCALE

    def replace(self, **kw) -> "Policy":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Decision:
    """How one op was routed — inspectable, so tests can prove which path
    decided."""
    use_kernel: bool
    source: str                    # "forced" | "analytical"
    op: str = "gemm"


# --------------------------------------------------------------------------
# The ambient policy: one contextvar + a process default.
# --------------------------------------------------------------------------

_DEFAULT = Policy()
_POLICY: contextvars.ContextVar[Optional[Policy]] = \
    contextvars.ContextVar("repro_torch_policy", default=None)


def current_policy() -> Policy:
    """The policy in effect: scoped override > installed default."""
    return _POLICY.get() or _DEFAULT


def install(policy: Optional[Policy] = None, **kw) -> Policy:
    """Set the process-wide default policy (model/launcher entry).

    Also turns TF32 off for the process, once: the library path widens
    every real operand to f32 (or f64), and an S GEMM must not silently
    become TF32."""
    global _DEFAULT
    torch.backends.cuda.matmul.allow_tf32 = False
    base = policy or _DEFAULT
    _DEFAULT = base.replace(**kw) if kw else base
    return _DEFAULT


@contextlib.contextmanager
def using(policy: Optional[Policy] = None, **kw):
    """Scoped policy override."""
    base = policy or current_policy()
    tok = _POLICY.set(base.replace(**kw) if kw else base)
    try:
        yield current_policy()
    finally:
        _POLICY.reset(tok)


def _resolve(policy: Optional[Policy]) -> Policy:
    return policy if policy is not None else current_policy()


#: Launcher backend names -> Policy.
POLICY_NAMES = BACKENDS


def named_policy(name: str) -> Policy:
    """Build the Policy a launcher flag means.

    ``library`` — every model matmul straight to ``torch.matmul``.
    ``kernel``  — every routed GEMM forced through the IAAT kernel.
    ``auto``    — the analytical input-aware criterion decides.
    ``tuned``   — route by a measured profile (raises: not ported yet).
    """
    if name == "library":
        return Policy(backend="library", iaat=False)
    if name in BACKENDS:
        return Policy(backend=name)
    raise ValueError(f"unknown policy name {name!r}; "
                     f"expected one of {POLICY_NAMES}")


def small_enough(M: int, N: int, K: int, trans: str = "NN",
                 policy: Optional[Policy] = None) -> bool:
    """The paper's input-aware criterion: cbrt(MNK) <= threshold."""
    pol = _resolve(policy)
    return (M * N * K) ** (1.0 / 3.0) <= pol.threshold(trans)


# --------------------------------------------------------------------------
# The router.
# --------------------------------------------------------------------------

class Router:
    """Routes every GEMM-shaped op through one decision path."""

    def __init__(self, policy: Optional[Policy] = None):
        self._policy = policy

    @property
    def policy(self) -> Policy:
        return _resolve(self._policy)

    def route(self, op: str, dims, dtype, trans: str = "NN") -> Decision:
        """Route one problem: forced backends first, then the analytical
        criterion.  With observability on, every call lands in the
        ``obs.ROUTES`` shape log, whose entry doubles as a decision memo
        (pure in op, dims, dtype, trans and the Policy object)."""
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
        pol = self.policy
        letter = dtype if type(dtype) is str else kernelgen.blas_letter(dtype)
        rl = obs.ROUTES
        if rl.on:
            key = (op, letter, trans, tuple(dims), id(pol))
            h = rl.hits.get(key)
            if h is not None and h[1] is pol and h[2] == rl.gen:
                h[0] += 1
                return h[3]
            d = self._decide(op, dims, letter, trans, pol)
            rl.note(key, pol, d)
            obs.TRACE.emit("ROUTE_MISS",
                           arg=(op, letter, trans, list(key[3]), d.source))
            return d
        return self._decide(op, dims, letter, trans, pol)

    @staticmethod
    def _decide(op: str, dims, letter: str, trans: str,
                pol: Policy) -> Decision:
        if op == "matmul":
            if len(dims) < 2:
                raise ValueError(f"matmul dims must be (*lead, K, N), "
                                 f"got {dims}")
            M = 1
            for d in dims[:-2]:
                M *= int(d)
            dims = (M, int(dims[-1]), int(dims[-2]))
        M, N, K = (int(d) for d in dims)
        if pol.backend == "kernel":
            return Decision(True, "forced", op)
        if pol.backend == "library":
            return Decision(False, "forced", op)
        use = small_enough(M, N, K, trans, pol) and plan_mod.build_plan(
            M, N, K, letter, trans).num_kernel_calls <= MAX_PLAN_REGIONS
        return Decision(use, "analytical", op)


_ROUTER = Router()


def route(op: str, dims, dtype, trans: str = "NN",
          policy: Optional[Policy] = None) -> Decision:
    """Module-level convenience over a shared :class:`Router`."""
    if policy is None:
        return _ROUTER.route(op, dims, dtype, trans)
    return Router(policy).route(op, dims, dtype, trans)


# --------------------------------------------------------------------------
# Executors.
# --------------------------------------------------------------------------

def _trans_str(trans_a: bool, trans_b: bool) -> str:
    return ("T" if trans_a else "N") + ("T" if trans_b else "N")


def _problem_dims(a_shape, b_shape, trans: str):
    M, Ka = (a_shape[1], a_shape[0]) if trans[0] == "T" else a_shape
    Kb, N = (b_shape[1], b_shape[0]) if trans[1] == "T" else b_shape
    if Ka != Kb:
        raise ValueError(f"K mismatch: {tuple(a_shape)} {trans[0]} vs "
                         f"{tuple(b_shape)} {trans[1]}")
    return int(M), int(N), int(Ka)


def _lib_gemm(a, b, c, alpha, beta, trans: str):
    """Library path with the kernel's epilogue rule (``_xla_gemm``):
    ``torch.matmul`` on operands widened to promote(dtype, f32), then
    beta*c added in that dtype BEFORE the one cast to result_type(a, b),
    so ``c`` cannot promote or demote the output relative to the kernel
    path.  It is the arithmetic of the kernel's plain version
    (``iaat_gemm.gemm_region_plain``) over the whole problem."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    acc = out_dtype if out_dtype.is_complex else \
        torch.promote_types(out_dtype, torch.float32)
    prod = templates.contract(a, b, trans, acc)
    return templates.epilogue_axpby(prod, c, alpha, beta, out_dtype)


def _plan_gemm(a, b, c, alpha, beta, trans: str):
    """Kernel path: every region of the plan is one kernel launch."""
    M, N, K = _problem_dims(a.shape, b.shape, trans)
    letter = kernelgen.blas_letter(torch.promote_types(a.dtype, b.dtype))
    p = plan_mod.build_plan(M, N, K, letter, trans)
    return plan_mod.execute(p, a, b, c, alpha, beta)


def gemm(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
         alpha=1.0, beta=0.0, trans_a: bool = False, trans_b: bool = False,
         *, policy: Optional[Policy] = None) -> torch.Tensor:
    """C = alpha * op(A) @ op(B) + beta * C with input-aware routing
    (the 2-D BLAS entry — the paper's ``iaat_gemm``)."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("gemm is the 2-D BLAS entry; use matmul()")
    pol = _resolve(policy)
    trans = _trans_str(trans_a, trans_b)
    M, N, K = _problem_dims(a.shape, b.shape, trans)
    letter = kernelgen.blas_letter(torch.promote_types(a.dtype, b.dtype))
    d = route("gemm", (M, N, K), letter, trans, policy=pol)
    if not d.use_kernel:
        return _lib_gemm(a, b, c, alpha, beta, trans)
    return _plan_gemm(a, b, c, alpha, beta, trans)


def matmul(x: torch.Tensor, w: torch.Tensor, *,
           policy: Optional[Policy] = None) -> torch.Tensor:
    """Framework matmul: (..., K) @ (K, N) with IAAT routing.

    Leading dims of ``x`` flatten into M.  ``w`` may be any strided
    (K, N) view — the tied ``embed.T`` reaches the kernel uncopied.  This
    is the hook through which every model projection reaches the paper's
    technique."""
    pol = _resolve(policy)
    if not pol.iaat:
        return torch.matmul(x, w)
    letter = kernelgen.blas_letter(torch.promote_types(x.dtype, w.dtype))
    d = route("matmul", tuple(x.shape) + (w.shape[-1],), letter,
              policy=pol)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not d.use_kernel:
        out = _lib_gemm(x2, w, None, 1.0, 0.0, "NN")
    else:
        out = _plan_gemm(x2, w, None, 1.0, 0.0, "NN")
    return out.reshape(*lead, w.shape[-1])
