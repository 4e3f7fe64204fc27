"""DSP on the DMR bank path: FM discriminator, RRC filter, century demod."""
from . import demod, fm, rrc  # noqa: F401
