"""K1f and K1b launches over the window (the program's counters
``phmm_tables.FWD_LAUNCHES`` and ``BWD_LAUNCHES``) a chunk clustered."""


def read(ctx):
    n = ctx.launches.get("fwd_tables", 0) + ctx.launches.get("bwd_tables", 0)
    if not ctx.units:
        return None
    return n / ctx.units
