"""Least time of the dense GEMMs the traced slice's train steps needed
(forward, recompute and both backward products of every projection and
of the head; ``work/counts.py``) over the device time of the kernels
that ran them (the IAAT kernel's, and what 2-D matmul ops launched)."""
from perfbench import trace as tr
from perfbench.work import counts


def read(ctx):
    data = ctx.get("slice")
    if ctx["kind"] != "train" or data is None or not ctx["slice_steps"]:
        return None
    t = tr.dense_gemm_s(data)
    if t <= 0:
        return None
    doc, mix = ctx["doc"], ctx["mix"]
    need = counts.gemms_bound_s(
        counts.train_step_gemms(doc, mix["batch"], mix["seq"]),
        counts.elt(doc)) * ctx["slice_steps"]
    return 100.0 * need / t
