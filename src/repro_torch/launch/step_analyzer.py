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
Here nothing needs weighting: the layer stacks, the microbatches and the
attention oracle's KV chunks are Python loops, so every iteration
dispatches its own ops, and a Python ``if`` dispatches only the branch
taken.  The IAAT, flash, grouped and SSD kernels launch through
``ctypes`` and are not aten ops, so the counter is meant for a step under
the library policy (``api.named_policy("library")``), as the reference's
dry run lowers under XLA.
"""
from __future__ import annotations

import collections
from typing import Dict

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


def _bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


class StepCounter(TorchDispatchMode):
    """``with StepCounter() as c: step()`` -> ``c.flops`` (matmul family),
    ``c.bytes`` (operands + outputs), ``c.ops`` (aten ops seen),
    ``c.dots`` (matmul-family ops) and ``c.flops_by_op``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.dots = 0
        self.flops_by_op: Dict[str, int] = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        f = self._formulas.get(func.overloadpacket)
        if f is not None:
            n = int(f(*args, **kwargs, out_val=out))
            self.flops += n
            self.dots += 1
            self.flops_by_op[str(func.overloadpacket)] += n
        if not _moves_nothing(func):
            self.bytes += _bytes((args, kwargs)) + _bytes(out)
        return out

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes, "ops": self.ops,
                "dots": self.dots, "flops_by_op": dict(self.flops_by_op)}
