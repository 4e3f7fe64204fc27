"""The device's idle share of the profiled slice (%): 100 less the union
of its operations' intervals over the slice's wall time."""
from benchmark.harness import devtrace


def read(ctx):
    if ctx.session is None or not ctx.session.device:
        return None
    busy = devtrace.union_us((s, e) for _, s, e in ctx.session.device) / 1e6
    return 100.0 * (1.0 - busy / ctx.slice_wall_s)
