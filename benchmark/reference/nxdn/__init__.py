"""NXDN: the symbol-domain decoder (sync hunt, frame machine with LICH,
the SACCH superframe and the FACCH1 slots' blocked trellises on the host,
metadata). The front is digiham's ``rrc_filter -n`` and 4FSK at sps 20:
the default slicer."""
from .decoder import make_decoder  # noqa: F401
