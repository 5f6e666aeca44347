"""One routing API: ``Policy`` + ``Router`` for every GEMM shape (port).

Counterpart of ``repro/api.py``.  The paper's thesis is that one
input-aware decision layer picks the kernel for every small GEMM:

* :class:`Policy` — one frozen routing config; one ambient policy
  (:func:`install` / :func:`using`) and a per-call ``policy=`` override.
* :class:`Router` — ``route(op, dims, dtype) -> Decision`` for ``gemm``
  (2-D BLAS), ``matmul`` (ND, leading dims flatten into M),
  ``batched_gemm`` (equal-capacity grouped) and ``ragged_gemm``
  (group-contiguous rows).  A grouped decision carries its block
  instance in ``Decision.blocks`` (``grouped_gemm.pick_blocks``).

Decision precedence:  forced (backend="kernel"/"library")  >  profile
(backend="tuned": the measured ``repro_torch.tune`` DeviceProfile)  >
analytical (smallness).  A ``tuned`` policy with no active profile, or
with no measured entry for the class, decides exactly as ``auto``.

Executors (:func:`gemm`, :func:`matmul`, :func:`batched_gemm`,
:func:`ragged_gemm`) act on the Decision: the kernel path runs the plan
through the hand-written CUDA kernels (``kernels/iaat_gemm.py``: the real
kernel for S/D/H, the complex Karatsuba kernel for C/Z; a profile's
winner pins a one-region plan through ``Decision.sig``) or the grouped
kernels (``kernels/grouped_gemm.py``); the 2-D library path runs
``torch.matmul`` in the accumulator dtype (the ``_xla_gemm`` epilogue
rule), the grouped one the reference's plain einsum in the operand dtype,
with TF32 off from :func:`install` on.
Every ``route`` call lands in :data:`repro_torch.obs.ROUTES`.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import time
from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core import (cost, kernelgen, paper_table, plan as plan_mod,
                              templates)
from repro_torch.kernels import grouped_gemm as _gg
from repro_torch.parallel import spmd

#: Cube edge at which a bf16 GEMM on an H100 turns from bytes-bound to
#: operations-bound: a cube n^3 moves 8n^2 bytes for 2n^3 flops, so its
#: intensity n/4 meets the ridge (989 TFLOP/s / 3.35 TB/s = 295) at
#: n = 4 * 295 = 1181.  Below it a no-pack kernel and the library move the
#: same bytes and the library's tensor-core advantage idles, so the small
#: regime extends to about there.  An UNMEASURED PRIOR, kept as the
#: ``auto`` criterion (the reference's semantics); the crossover the
#: port's tuner measures on the card stands beside it (DESIGN_PORT.md §4),
#: and ``backend="tuned"`` routes by that measurement.
HOPPER_CROSSOVER = 4.0 * cost.RIDGE_BF16
#: The paper's 80/32 thresholds scaled to that crossover (~14.8).
HOPPER_SCALE = HOPPER_CROSSOVER / paper_table.PAPER_SMALL_THRESHOLD

#: The most regions (one kernel launch each) a plan may have and still
#: count as the small regime.  Under ``auto`` a longer plan routes to the
#: library, and ``ROUTES`` records it so; the forced-kernel policy runs
#: every plan through the kernel, however long (the reference's valve).
#: A complex plan of this many regions is one launch.
MAX_PLAN_REGIONS = plan_mod.LAUNCH_REGIONS

#: Op kinds the router understands, with their ``dims`` convention:
#:   gemm          (M, N, K)            2-D BLAS entry
#:   matmul        (*lead, K, N)        x.shape + (N,); M = prod(lead)
#:   batched_gemm  (G, C, K, N)         per-group problem is (C, K, N)
#:   ragged_gemm   (G, bm, K, N)        per-tile problem is (bm, K, N)
OPS = ("gemm", "matmul", "batched_gemm", "ragged_gemm")
_GROUPED = ("batched_gemm", "ragged_gemm")
BACKENDS = ("kernel", "library", "auto", "tuned")
#: ``Policy.kernels``: the non-GEMM kernel family; "" derives it from
#: ``backend``
KERNEL_FAMILIES = ("", "kernel", "library")


@dataclasses.dataclass(frozen=True)
class Policy:
    """The single routing policy every GEMM-shaped op consults.

    ``backend``: ``kernel`` forces the IAAT kernel, ``library`` forces
    ``torch.matmul``, ``auto`` applies the analytical criterion, ``tuned``
    routes by the active measured profile (``repro_torch.tune``) and
    falls back to the analytical criterion where it has no entry.
    ``iaat=False`` sends model matmuls straight to ``torch.matmul``; the
    MoE expert FFN's grouped GEMMs still follow ``backend``.
    ``kernels`` picks the non-GEMM kernel family (flash attention, the
    grouped expert FFN, the SSD scan): ``kernel`` or ``library``, the
    empty string deriving it from ``backend`` (the reference's
    ``kernels``, whose ``pallas``/``xla`` these are).  The trainer pins it
    to ``library``, since those kernels have no backward, while GEMM
    routing stays input-aware.
    """
    backend: str = "auto"
    paper_thresholds: bool = False  # use the ARMv8 80/32 bounds verbatim
    iaat: bool = True
    kernels: str = ""

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected "
                             f"one of {BACKENDS}")
        if self.kernels not in KERNEL_FAMILIES:
            raise ValueError(f"unknown kernel family {self.kernels!r}; "
                             f"expected one of {KERNEL_FAMILIES}")

    def threshold(self, trans: str) -> float:
        base = (paper_table.PAPER_SMALL_THRESHOLD_TN if trans == "TN"
                else paper_table.PAPER_SMALL_THRESHOLD)
        return base if self.paper_thresholds else base * HOPPER_SCALE

    @property
    def use_kernels(self) -> bool:
        """True when the non-GEMM family is ``kernel`` (``kernels`` where
        set, else every backend but the forced library): the grouped paths
        (the MoE expert FFN) then call the grouped executors, attention
        over a whole prompt runs the flash kernel and a mamba layer's scan
        the SSD kernel; the reference's ``Policy.pallas``."""
        if self.kernels:
            return self.kernels == "kernel"
        return self.backend != "library"

    def replace(self, **kw) -> "Policy":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Decision:
    """How one op was routed — inspectable, so tests can prove which path
    decided."""
    use_kernel: bool
    source: str                    # "forced" | "profile" | "analytical"
    op: str = "gemm"
    blocks: Optional[Tuple[int, int, int]] = None  # grouped table instance
    sig: Optional[kernelgen.KernelSig] = None      # tuned 2-D plan override


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
    ``tuned``   — route by the measured profile (``repro_torch.tune``).
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

def _grouped_problem(op: str, dims) -> Tuple[int, int, int, int]:
    if len(dims) != 4:
        raise ValueError(f"{op} dims must be (G, C|bm, K, N), got {dims}")
    G, C, K, N = (int(d) for d in dims)
    return G, C, K, N


class Router:
    """Routes every GEMM-shaped op through one decision path."""

    def __init__(self, policy: Optional[Policy] = None):
        self._policy = policy

    @property
    def policy(self) -> Policy:
        return _resolve(self._policy)

    def route(self, op: str, dims, dtype, trans: str = "NN") -> Decision:
        """Route one problem: forced backends first, then the measured
        profile (``tuned``), then the analytical criterion.  With
        observability on, every call lands in the ``obs.ROUTES`` shape
        log, whose entry doubles as a decision memo (pure in op, dims,
        dtype, trans, the Policy object and the active profile: a profile
        swap resets the log)."""
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
        if op in _GROUPED:
            return Router._route_grouped(op, dims, letter, pol)
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
        if pol.backend == "tuned":
            entry = Router._profile_entry(M, N, K, letter, trans)
            if entry is not None:
                if entry.prefer_kernel:
                    return Decision(True, "profile", op, sig=entry.sig)
                return Decision(False, "profile", op)
        use = small_enough(M, N, K, trans, pol) and plan_mod.build_plan(
            M, N, K, letter, trans).num_kernel_calls <= MAX_PLAN_REGIONS
        return Decision(use, "analytical", op)

    @staticmethod
    def _route_grouped(op: str, dims, letter: str,
                       pol: Policy) -> Decision:
        """Grouped ops: the per-group (C, K, N) problem is the routing unit
        (for ragged, the per-tile (bm, K, N)); the table instance travels
        in ``Decision.blocks``, populated under every backend because the
        kernel entries need it.  Letters without a grouped kernel get
        none.  Under ``tuned`` an entry measured on the grouped kernel
        decides, else the 2-D entry of the per-group shape; its winner is
        a whole table instance, which the ragged kernel takes as it is
        (its row tile is a separate argument)."""
        G, C, K, N = _grouped_problem(op, dims)
        blocks = None
        if letter in kernelgen.KERNEL_LETTERS:
            dtype = {**kernelgen.BLAS_DTYPES,
                     **kernelgen.FRAMEWORK_DTYPES}[letter]
            blocks = _gg.pick_blocks(C, K, N, dtype)
        if pol.backend == "kernel":
            return Decision(True, "forced", op, blocks)
        if pol.backend == "library":
            return Decision(False, "forced", op, blocks)
        if pol.backend == "tuned":
            entry = Router._grouped_profile_entry(C, N, K, letter)
            if entry is not None:
                if entry.sig is not None and blocks is not None:
                    blocks = (entry.sig.bm, entry.sig.bn, entry.sig.bk)
                return Decision(entry.prefer_kernel, "profile", op, blocks,
                                sig=entry.sig)
        return Decision(small_enough(C, N, K, "NN", pol), "analytical", op,
                        blocks)

    @staticmethod
    def _profile_entry(M, N, K, letter, trans):
        from repro_torch.tune import profile as profile_mod
        prof = profile_mod.active_profile()
        if prof is None:
            return None
        entry = prof.lookup_dims(M, N, K, letter, trans)
        if entry is None or not entry.measured:
            return None
        return entry

    @staticmethod
    def _grouped_profile_entry(C, N, K, letter):
        from repro_torch.tune import profile as profile_mod
        prof = profile_mod.active_profile()
        if prof is None:
            return None
        entry = prof.lookup_grouped_dims(C, N, K, letter)
        if entry is None or not entry.measured:
            entry = prof.lookup_dims(C, N, K, letter, "NN")
        if entry is None or not entry.measured:
            return None
        return entry


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


def _plan_gemm(d: Decision, a, b, c, alpha, beta, trans: str):
    """Kernel path: every region of the plan is one kernel launch; a
    profile's winner (``d.sig``) pins a one-region plan."""
    M, N, K = _problem_dims(a.shape, b.shape, trans)
    letter = kernelgen.blas_letter(torch.promote_types(a.dtype, b.dtype))
    p = plan_mod.build_plan(M, N, K, letter, trans, override=d.sig)
    return plan_mod.execute(p, a, b, c, alpha, beta)


def gemm(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
         alpha=1.0, beta=0.0, trans_a: bool = False, trans_b: bool = False,
         *, policy: Optional[Policy] = None) -> torch.Tensor:
    """C = alpha * op(A) @ op(B) + beta * C with input-aware routing
    (the 2-D BLAS entry — the paper's ``iaat_gemm``).  Inside an
    ``obs.capture`` the call, from its route to its last launch, is one
    cheap ``gemm.dispatch`` record."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("gemm is the 2-D BLAS entry; use matmul()")
    if obs.capturing():
        t0 = time.perf_counter_ns()
        out = _gemm(a, b, c, alpha, beta, trans_a, trans_b, policy)
        obs.mark("gemm.dispatch", t0)
        return out
    return _gemm(a, b, c, alpha, beta, trans_a, trans_b, policy)


def _gemm(a, b, c, alpha, beta, trans_a: bool, trans_b: bool,
          policy: Optional[Policy]) -> torch.Tensor:
    pol = _resolve(policy)
    trans = _trans_str(trans_a, trans_b)
    M, N, K = _problem_dims(a.shape, b.shape, trans)
    letter = kernelgen.blas_letter(torch.promote_types(a.dtype, b.dtype))
    d = route("gemm", (M, N, K), letter, trans, policy=pol)
    if not d.use_kernel:
        return _lib_gemm(a, b, c, alpha, beta, trans)
    return _plan_gemm(d, a, b, c, alpha, beta, trans)


def matmul(x: torch.Tensor, w: torch.Tensor, *,
           policy: Optional[Policy] = None) -> torch.Tensor:
    """Framework matmul: (..., K) @ (K, N) with IAAT routing.

    Leading dims of ``x`` flatten into M.  ``w`` may be any strided
    (K, N) view — the tied ``embed.T`` reaches the kernel uncopied.  This
    is the hook through which every model projection reaches the paper's
    technique.

    On DTensors (a train step on several ranks) the weight is gathered
    over the batch axes (FSDP) and this same routed GEMM runs on each
    rank's local shards (``parallel/spmd.sharded_matmul``), so the route
    and the kernel see the local (M, N, K).  Inside an ``obs.capture`` each
    local call is one cheap ``gemm.dispatch`` record."""
    if spmd.any_dtensor(x, w):
        return spmd.sharded_matmul(x, w, functools.partial(
            matmul, policy=policy))
    if obs.capturing():
        t0 = time.perf_counter_ns()
        out = _matmul(x, w, policy)
        obs.mark("gemm.dispatch", t0)
        return out
    return _matmul(x, w, policy)


def _matmul(x: torch.Tensor, w: torch.Tensor,
            policy: Optional[Policy]) -> torch.Tensor:
    pol = _resolve(policy)
    if not pol.iaat:
        return torch.matmul(x, w)
    letter = kernelgen.blas_letter(torch.promote_types(x.dtype, w.dtype))
    d = route("matmul", tuple(x.shape) + (w.shape[-1],), letter,
              policy=pol)
    flat = x.ndim == 2
    x2 = x if flat else x.reshape(-1, x.shape[-1])
    if not d.use_kernel:
        out = _lib_gemm(x2, w, None, 1.0, 0.0, "NN")
    else:
        out = _plan_gemm(d, x2, w, None, 1.0, 0.0, "NN")
    return out if flat else out.reshape(*x.shape[:-1], w.shape[-1])


def batched_gemm(x: torch.Tensor, w: torch.Tensor, *,
                 policy: Optional[Policy] = None) -> torch.Tensor:
    """Equal-capacity grouped GEMM: x (G, C, K) @ w (G, K, N) -> (G, C, N),
    routed per the per-group problem; the library path is the reference's
    plain batched einsum in the operand dtype."""
    pol = _resolve(policy)
    G, C, K = x.shape
    N = w.shape[-1]
    d = route("batched_gemm", (G, C, K, N),
              torch.promote_types(x.dtype, w.dtype), policy=pol)
    if not d.use_kernel:
        return torch.einsum("gck,gkn->gcn", x, w)
    return _gg.batched_gemm(x, w, blocks=d.blocks)


def ragged_gemm(x: torch.Tensor, w: torch.Tensor,
                tile_group_ids: torch.Tensor, *, bm: int = 128,
                policy: Optional[Policy] = None) -> torch.Tensor:
    """Ragged grouped GEMM (group-contiguous rows in row tiles of ``bm``):
    x (T, K) @ w (G, K, N) -> (T, N); the library path gathers each
    tile's group weight and einsums, as the reference's does."""
    pol = _resolve(policy)
    T, K = x.shape
    G, _, N = w.shape
    d = route("ragged_gemm", (G, bm, K, N),
              torch.promote_types(x.dtype, w.dtype), policy=pol)
    if not d.use_kernel:
        wt = w[tile_group_ids.long()]              # (T // bm, K, N)
        xt = x.reshape(-1, bm, K)
        return torch.einsum("tbk,tkn->tbn", xt, wt).reshape(T, N)
    return _gg.ragged_gemm(x, w, tile_group_ids, bm=bm, blocks=d.blocks)
