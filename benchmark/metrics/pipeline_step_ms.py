"""The pipeline step a step (ms): the wrapped ``step_symbols`` to its
synchronize, K2 with the dense sync correlation."""


def read(ctx):
    if not ctx.steps:
        return None
    return ctx.step_s / ctx.steps * 1e3
