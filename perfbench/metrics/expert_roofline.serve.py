"""Least time of the expert work the traced slice needed over the device
time of the ragged kernel's launches in it.  The work
(``families/<family>.py`` ``expert_work``) is each touched expert's three
matrices read once, plus the routed rows' operations and activations,
from the program's device tally ``moe`` (pairs and experts touched,
summed over the slice's MoE calls); the time is every
``grouped_gemm_kernel`` launch of the slice, read only where their
number is the tally's three a call (every grouped launch a tile call's
gate, up or down).  None where the program keeps no such tally."""
from perfbench import spec
from perfbench.work import counts


def read(ctx):
    data = ctx.get("slice")
    if ctx["kind"] != "serve" or data is None:
        return None
    from repro_torch import obs
    tallies = getattr(obs, "tallies", None)
    t = tallies().get("moe") if tallies is not None else None
    if not t:
        return None
    launches = [k for k in data["kernels"]
                if "grouped_gemm_kernel" in k["name"]]
    if len(launches) != 3 * t["calls"]:
        return None
    dev_s = sum(k["dur"] for k in launches) * 1e-6
    if dev_s <= 0:
        return None
    doc = ctx["doc"]
    flops, nbytes = spec.family(doc["family"]).expert_work(
        doc, t["pairs"], t["experts_touched"], counts.elt(doc))
    return 100.0 * counts.bound_s(flops, nbytes) / dev_s
