"""FEC on the bank paths: linear block codes, BPTC(196,96), CRCs,
keystreams, the 16-state Viterbi, and the host numpy twins the phase
machines use (``linear.decode_np``, ``bptc.decode_np``, ``rs129``)."""
from . import (bptc, codes, crc, interleave, lfsr, linear,  # noqa: F401
               rs129, viterbi)
