"""DMR: the symbol-domain decoder (sync hunt, TDMA frame machine, host
FEC, metadata)."""
from .decoder import make_decoder  # noqa: F401
