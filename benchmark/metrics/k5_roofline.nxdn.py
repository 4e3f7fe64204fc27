"""K5's share of its roofline in an NXDN cell (%): the least time the card
could take for the slice's NXDN decode rounds, each frame's SACCH
trellis of 36 steps and its two FACCH1 slots' trellises of 96 steps (the
rows the round was given that hold a frame; its zero padding is not work
the inputs need), over K5's device time there."""
from benchmark.harness import devtrace, roofline

SACCH_STEPS = 36   # a SACCH unit: 60 bits depunctured to 72, 36 dibits
FACCH1_STEPS = 96  # a FACCH1 slot: 144 bits depunctured to 192, 96 dibits
FACCH1_SLOTS = 2   # both slots of a frame are decoded


def round_bound_s(frames: int) -> float:
    """The least time of one decode round of ``frames`` frames."""
    rows = FACCH1_SLOTS * frames
    return roofline.bound_s(
        roofline.viterbi_bytes(frames, SACCH_STEPS)
        + roofline.viterbi_bytes(rows, FACCH1_STEPS),
        roofline.viterbi_operations(frames, SACCH_STEPS)
        + roofline.viterbi_operations(rows, FACCH1_STEPS))


def read(ctx):
    if ctx.session is None or not ctx.slice_rounds:
        return None
    launches, seconds = devtrace.kernel_seconds(ctx.session, "viterbi_kernel")
    if not launches or seconds <= 0:
        return None
    return 100.0 * sum(map(round_bound_s, ctx.slice_rounds)) / seconds
