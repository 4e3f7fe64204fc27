"""YSF protocol: frame constants and the host phase machines."""
from . import constants  # noqa: F401
from .decoder import make_decoder  # noqa: F401
from .fich import Fich  # noqa: F401
from .meta import MetaCollector  # noqa: F401
from .phases import FramePhase, SyncPhase  # noqa: F401
