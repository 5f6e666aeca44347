"""A step's work counted per aten op (counterpart of
``repro/launch/hlo_analyzer.py``).

:class:`StepCounter` is a ``TorchDispatchMode``: every aten op the step
dispatches, on meta tensors (the dry run: shapes, no storage) or real
ones (the card), adds

  * its matmul-family FLOPs, by ``torch.utils.flop_counter``'s registry
    (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions, SDPA): the
    reference's "dot FLOPs";
  * its operand + output bytes, views and allocations excepted: the
    reference's fusion-opaque traffic, which is what eager torch moves,
    one op at a time.

The reference multiplies each HLO loop body by its trip count and
weights ``lax.cond`` branches, because XLA prints a scanned layer once.
Here the layer stacks, the microbatches and the attention oracle's KV
chunks are Python loops, so every iteration dispatches its own ops, and
a Python ``if`` dispatches only the branch taken.  One loop is weighted
instead: the serving recurrence's token loop (``ssm.paged_step``), whose
iterations are alike, runs its body once on meta tensors under an active
counter, counted :func:`trip_count` times (the reference's
``known_trip_count``), so a 32k-token prefill costs one token's ops.

On several ranks the step's tensors are DTensors, which a dispatch mode
would see with their global shapes before DTensor splits the op; the
counter hands those ops back (``NotImplemented``), so DTensor runs them
and the counter sees the local ops of this rank: its FLOPs and bytes are
one rank's.  The collectives DTensor issues (``_c10d_functional``) are
counted apart, by kind, with the bytes of their outputs on this rank
(the reference's ``collective_bytes``), and not as memory traffic.

The counter also follows the step's memory (the reference's
``memory_analysis``, which XLA reports from its buffer assignment): every
storage an op allocates (an output that shares no input's storage) is
live from that op until the last tensor on it is gone (a weak reference
on the storage, whose callback runs when its memory is released), so
``peak_live`` is the most bytes the step held at once beyond what it was
given: the arguments are allocated before the counter starts, and views
and in-place ops allocate nothing.  Meta storages have their sizes, so
the peak on the meta device is the peak of the same step on real
tensors (as far as eager torch allocates through the dispatcher: a
kernel's own scratch is not seen, nor the caching allocator's rounding).
On DTensors the storages are this rank's local ones.
:func:`output_terms` gives the returned leaves' bytes and the part of
them that shares an argument's storage (updated in place).

The IAAT, flash, grouped and SSD kernels launch through ``ctypes`` and
are not aten ops, so the counter is meant for a step under the library
policy (``api.named_policy("library")``), as the reference's dry run
lowers under XLA.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

#: ops that allocate or relabel storage and move no bytes
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten._unsafe_view.default,
               aten.lift_fresh.default}


def _moves_nothing(func) -> bool:
    """A view (its output aliases an input and is not written) or an
    allocation."""
    if func in _NO_TRAFFIC:
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


#: collective kinds, the reference's names, by ``_c10d_functional`` op
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "broadcast": "broadcast", "broadcast_": "broadcast"}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "broadcast")

_ACTIVE: List["StepCounter"] = []
_FAKE = torch._C._TorchDispatchModeKey.FAKE


def trip_counting() -> bool:
    """Whether the active :class:`StepCounter` weights alike loop
    iterations by their trip count (:func:`trip_count`)."""
    return bool(_ACTIVE) and _ACTIVE[-1].trip_counts


@contextlib.contextmanager
def trip_count(n: int):
    """Every op dispatched inside counts ``n`` times in the active
    counter (a loop body run once for ``n`` alike iterations)."""
    c = _ACTIVE[-1]
    prev, c.weight = c.weight, c.weight * n
    try:
        yield
    finally:
        c.weight = prev


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, type) and issubclass(t, DTensor)


def _bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a step's arguments or results (dicts, lists,
    tuples, dataclasses such as a cache, modules' parameters and
    buffers), a DTensor as this rank's local tensor."""
    from torch import nn
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return [tree._local_tensor]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return _tensors(list(tree.parameters()) + list(tree.buffers()))
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def output_terms(arguments, outputs) -> Tuple[int, int]:
    """(bytes of the tensors of ``outputs``, the part of them that shares
    a storage with a tensor of ``arguments``): the reference's output and
    alias sizes, this rank's."""
    held = {_storage_key(t) for t in _tensors(arguments)}
    out = alias = 0
    for t in _tensors(outputs):
        n = t.numel() * t.element_size()
        out += n
        if _storage_key(t) in held:
            alias += n
    return out, alias


class StepCounter(TorchDispatchMode):
    """``with StepCounter() as c: step()`` -> ``c.flops`` (matmul family),
    ``c.bytes`` (operands + outputs), ``c.ops`` (aten ops seen),
    ``c.dots`` (matmul-family ops), ``c.flops_by_op``, and the
    collectives: ``c.coll_bytes`` and ``c.coll_count`` by kind (one
    rank's, on DTensors), and the memory: ``c.live`` bytes allocated in
    the step and not yet released, ``c.peak_live`` their most.
    ``trip_counts=False`` has the weighted loops run every iteration (the
    same counts, one op at a time)."""

    def __init__(self, trip_counts: bool = True):
        super().__init__()
        self.trip_counts = trip_counts
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.weight = 1
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.dots = 0
        self.flops_by_op: Dict[str, int] = collections.Counter()
        self.coll_bytes: Dict[str, int] = {k: 0 for k in KINDS}
        self.coll_count: Dict[str, int] = {k: 0 for k in KINDS}
        self.live = 0
        self.peak_live = 0
        self._storages: Dict[int, weakref.ref] = {}
        self.output_bytes: Optional[int] = None
        self.alias_bytes: Optional[int] = None

    def returned(self, arguments, outputs) -> None:
        """Record the step's output and alias bytes (:func:`output_terms`
        of its ``arguments`` and what it returned)."""
        self.output_bytes, self.alias_bytes = output_terms(arguments,
                                                           outputs)

    def _release(self, key: int, n: int, _ref) -> None:
        self._storages.pop(key, None)
        self.live -= n

    def _allocated(self, args, kwargs, out) -> None:
        """Start following every storage of ``out`` that no input shares."""
        new = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not new:
            return
        ins = {_storage_key(t) for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)}
        for t in new:
            st = t.untyped_storage()
            key = st._cdata
            if key in ins or key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = weakref.ref(st, functools.partial(
                self._release, key, n))
            self.live += n
            self.peak_live = max(self.peak_live, self.live)

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented        # DTensor splits it: count locals
        kwargs = kwargs or {}
        if torch._C._get_dispatch_mode(_FAKE) is not None:
            # DTensor's sharding propagation runs the op on fake tensors of
            # the global shapes: no work, no memory of this rank
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        self._allocated(args, kwargs, out)
        w = self.weight
        pkt = func.overloadpacket
        if getattr(pkt, "_qualified_op_name", "").startswith(
                "_c10d_functional::"):
            kind = COLLECTIVES.get(pkt.__name__)
            if kind is not None:
                self.coll_count[kind] += w
                self.coll_bytes[kind] += w * _bytes(out)
            return out
        self.ops += w
        f = self._formulas.get(pkt)
        if f is not None:
            n = int(f(*args, **kwargs, out_val=out))
            self.flops += w * n
            self.dots += w
            self.flops_by_op[str(pkt)] += w * n
        if not _moves_nothing(func):
            self.bytes += w * (_bytes((args, kwargs)) + _bytes(out))
        return out

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes, "ops": self.ops,
                "dots": self.dots, "flops_by_op": dict(self.flops_by_op),
                "coll_bytes": dict(self.coll_bytes),
                "coll_count": dict(self.coll_count),
                "peak_live": self.peak_live,
                "output_bytes": self.output_bytes,
                "alias_bytes": self.alias_bytes}
