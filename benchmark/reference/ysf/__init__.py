"""YSF: the symbol-domain decoder (sync hunt, frame machine with FICH,
DCH and the header's trellises, metadata)."""
from .decoder import make_decoder  # noqa: F401
