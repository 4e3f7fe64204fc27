"""DSP on the bank paths: FM discriminator, RRC filter, century demod."""
from . import demod, fm, rrc  # noqa: F401
