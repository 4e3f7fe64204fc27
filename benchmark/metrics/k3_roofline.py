"""K3's share of its roofline (%): the least time the card could take for
the slice's bank steps (each a block of every channel straight into the
2FSK century demod, with no filter) over K3's device time there. K3 is
``demod_kernel`` with no filter stage; a cell with no RRC launches no
other. Bytes: the float32 samples in, the carry (pos, offset, the
100-volume ring) in and out, a byte a bit out; no taps and no history.
Operations: :func:`benchmark.harness.roofline.demod_operations` with no
taps. The block is taken at its least length, ``n_centuries * (100 sps +
1) + 2`` samples, so the share is never counted high."""
from benchmark.harness import devtrace, roofline

CARRY = 4 + 4 + 4 * 100  # pos, offset, the volume ring


def step_bound_s(channels: int, n_centuries: int, sps: int) -> float:
    """The least time of one step of ``channels`` channels."""
    L = n_centuries * (100 * sps + 1) + 2
    moved = channels * (4 * L + 2 * CARRY + n_centuries * 100)
    return roofline.bound_s(
        moved, roofline.demod_operations(channels, L, 0, n_centuries, sps))


def read(ctx):
    if ctx.session is None:
        return None
    launches, seconds = devtrace.kernel_seconds(ctx.session, "demod_kernel")
    if not launches or seconds <= 0:
        return None
    cfg = ctx.cell.config
    return 100.0 * launches * step_bound_s(
        cfg["channels"], cfg["n_centuries"], cfg["sps"]) / seconds
