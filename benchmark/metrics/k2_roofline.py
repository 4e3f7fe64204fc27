"""K2's share of its roofline (%): the least time the card could take for
the slice's bank steps (each a block of every channel through the RRC
and the century demod, :mod:`benchmark.harness.roofline`) over K2's
device time there. The block is taken at its least length,
``n_centuries * (100 sps + 1) + 2`` samples, so the share is never
counted high."""
from benchmark.harness import devtrace, roofline


def read(ctx):
    if ctx.session is None:
        return None
    launches, seconds = devtrace.kernel_seconds(ctx.session, "demod_kernel")
    if not launches or seconds <= 0:
        return None
    cfg = ctx.cell.config
    C, nc, sps, ntaps = (cfg["channels"], cfg["n_centuries"], cfg["sps"],
                         cfg["rrc_taps"])
    L = nc * (100 * sps + 1) + 2
    least = roofline.bound_s(roofline.demod_bytes(C, L, ntaps, nc),
                             roofline.demod_operations(C, L, ntaps, nc, sps))
    return 100.0 * launches * least / seconds
