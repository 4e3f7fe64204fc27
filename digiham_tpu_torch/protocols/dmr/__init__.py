"""DMR protocol: frame constants and the host phase machines."""
from . import constants  # noqa: F401
from .decoder import Decoder, make_decoder  # noqa: F401
from .meta import MetaCollector, Slot  # noqa: F401
from .phases import (SYNCTYPE_DATA, SYNCTYPE_VOICE, FramePhase,  # noqa: F401
                     SyncPhase)
