"""K5's share of its roofline (%): the least time the card could take for
the slice's YSF decode rounds, each frame's FICH and DCH trellises of 100
steps (the rows the round was given that hold a frame; its zero padding
is not work the inputs need), over K5's device time there."""
from benchmark.harness import devtrace, roofline

STEPS = 100       # FICH and DCH each decode 100 trellis steps
TRELLISES = 2     # of them a frame


def read(ctx):
    if ctx.session is None or not ctx.slice_rounds:
        return None
    launches, seconds = devtrace.kernel_seconds(ctx.session, "viterbi_kernel")
    if not launches or seconds <= 0:
        return None
    least = sum(roofline.bound_s(
        roofline.viterbi_bytes(TRELLISES * n, STEPS),
        roofline.viterbi_operations(TRELLISES * n, STEPS))
        for n in ctx.slice_rounds)
    return 100.0 * least / seconds
