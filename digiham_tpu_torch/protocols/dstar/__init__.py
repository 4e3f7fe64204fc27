"""D-Star protocol: the header codec and the host phase machines."""
from .decoder import make_decoder  # noqa: F401
from .header import Header  # noqa: F401
from .meta import MetaCollector  # noqa: F401
from .phases import HeaderPhase, SyncPhase, VoicePhase  # noqa: F401
