"""FEC on the bank paths: linear block codes, BPTC(196,96), CRCs,
keystreams and the 16-state Viterbi."""
from . import (bptc, codes, crc, interleave, lfsr, linear,  # noqa: F401
               viterbi)
