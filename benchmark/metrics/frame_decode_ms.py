"""The symbol tail a step (ms): the wrapped ``decode_fields`` calls of the
step's decode rounds, summed (batched FEC on the card, K5 for YSF, and
the fetch of every field)."""


def read(ctx):
    if not ctx.steps:
        return None
    return ctx.decode_s / ctx.steps * 1e3
