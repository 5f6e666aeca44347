"""Share of the expert rows computed in the traced slice that a routed
(token, expert) pair used: the program's device tally ``moe``
(``layers.MOE_TALLY``, summed over the slice's MoE calls and read once
after it) as pairs over tile rows.  None where the program keeps no
such tally."""


def read(ctx):
    if ctx["kind"] != "serve" or ctx.get("slice") is None:
        return None
    from repro_torch import obs
    tallies = getattr(obs, "tallies", None)
    t = tallies().get("moe") if tallies is not None else None
    if not t or not t["tile_rows"]:
        return None
    return 100.0 * t["pairs"] / t["tile_rows"]
