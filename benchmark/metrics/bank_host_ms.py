"""The bank's host time a step (ms): the pushes' wall time less the
wrapped ``step_symbols`` and ``decode_fields``: buffering, the hunt with
its fast skip, the trackers and the metadata."""


def read(ctx):
    if not ctx.steps:
        return None
    return (ctx.push_s - ctx.step_s - ctx.decode_s) / ctx.steps * 1e3
