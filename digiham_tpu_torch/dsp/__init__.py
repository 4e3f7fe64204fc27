"""DSP: FM discriminator and DC blocker, RRC filter, century demod, the
digital-voice post-filter."""
from . import audio, demod, fm, rrc  # noqa: F401
from .audio import (DigitalVoiceFilterNp, DigitalVoiceState,  # noqa: F401
                    digitalvoice_filter)
from .fm import DcBlockState, dc_block, fm_discriminator  # noqa: F401
from .rrc import (NARROW_RRC, WIDE_RRC, RrcState, RrcStreamNp,  # noqa: F401
                  rrc_filter, rrc_filter_block, rrc_filter_np)
