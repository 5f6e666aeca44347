"""Mean share of the engine's slots that hold a request, over the
window's engine steps: the engine's ``serve.slot_occupancy`` samples
(one a step that worked; their count and sum are exact), differenced
over the window."""


def read(ctx):
    c = ctx["counters"]
    if ctx["kind"] != "serve" or not c.get("occupancy_n"):
        return None
    return 100.0 * c["occupancy_sum"] / c["occupancy_n"]
