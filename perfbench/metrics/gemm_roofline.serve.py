"""Least time of the dense GEMMs the traced slice's model calls needed
(every layer's projections and the head; at each call's real
rows; ``work/counts.py``) over the device time of the kernels that ran
them (the IAAT kernel's, and what 2-D matmul ops launched)."""
from perfbench import trace as tr
from perfbench.work import counts


def read(ctx):
    data, rows = ctx.get("slice"), ctx.get("slice_rows")
    if ctx["kind"] != "serve" or data is None or not rows:
        return None
    t = tr.dense_gemm_s(data)
    if t <= 0:
        return None
    doc = ctx["doc"]
    need = sum(counts.gemms_bound_s(counts.pass_gemms(doc, len(r)),
                                    counts.elt(doc)) for r in rows if len(r))
    return 100.0 * need / t
