"""D-Star: the bit-domain decoder (sync hunt for the header and voice
syncs, the 660-bit header, voice frames with the terminator checks and the
slow-data collector, metadata). The front is digiham's ``fsk_demodulator
-s 10`` with no filter: the 2FSK slicer, bits not dibits."""
from .decoder import make_decoder  # noqa: F401

DEMOD = "fsk"
