"""The block codes of the DMR, YSF and POCSAG paths (port of
``digiham_tpu/fec/codes.py``).

Parity-check matrices are protocol interoperability data from the ETSI
specs as the reference implementation encodes them (file:line per code).
Bit ``l`` of each row is the coefficient of codeword bit ``l`` (LSB = last
received bit).
"""
from .linear import BlockCode

# ETSI TS 102 361-1 B.3.5 — src/dmr_decoder/hamming_7_4.c:18-22
HAMMING_7_4 = BlockCode(
    "hamming_7_4", 7, 4,
    (0b01110100, 0b00111010, 0b01101001),
    correct_bits=1,
)

# ETSI B.3.4 — src/dmr_decoder/hamming_13_9.c:23-28
HAMMING_13_9 = BlockCode(
    "hamming_13_9", 13, 9,
    (
        0b1101011001000,
        0b1110101100100,
        0b1111010110010,
        0b1010110010001,
    ),
    correct_bits=1,
)

# ETSI B.3.4 — src/dmr_decoder/hamming_15_11.c:24-30
HAMMING_15_11 = BlockCode(
    "hamming_15_11", 15, 11,
    (
        0b111101011001000,
        0b011110101100100,
        0b001111010110010,
        0b111010110010001,
    ),
    correct_bits=1,
)

# ETSI B.3.4 (SPC-extended) — src/dmr_decoder/hamming_16_11.c:28-34
HAMMING_16_11 = BlockCode(
    "hamming_16_11", 16, 11,
    (
        0b1111010110010000,
        0b0111101011001000,
        0b0011110101100100,
        0b1110101100100010,
        0b1010011011100001,
    ),
    correct_bits=1,
)

# ETSI B.3.1 Golay(20,8) — src/dmr_decoder/golay_20_8.c:29-42
GOLAY_20_8 = BlockCode(
    "golay_20_8", 20, 8,
    (
        0b01001111100000000000,
        0b01101000010000000000,
        0b10110100001000000000,
        0b11011010000100000000,
        0b11101101000010000000,
        0b10111001000001000000,
        0b00010011000000100000,
        0b11000110000000010000,
        0b11100011000000001000,
        0b00111110000000000100,
        0b10011111000000000010,
        0b01110101000000000001,
    ),
    correct_bits=3,
)

# Golay(24,12), YSF spec Appendix A — src/ysf_decoder/golay_24_12.c:34-47
GOLAY_24_12 = BlockCode(
    "golay_24_12", 24, 12,
    (
        0b101001001111100000000000,
        0b111101101000010000000000,
        0b011110110100001000000000,
        0b001111011010000100000000,
        0b000111101101000010000000,
        0b101010111001000001000000,
        0b111100010011000000100000,
        0b110111000110000000010000,
        0b011011100011000000001000,
        0b100100111110000000000100,
        0b010010011111000000000010,
        0b110001110101000000000001,
    ),
    correct_bits=3,
)

# ETSI B.3.2 quadratic residue (16,7,6) —
# src/dmr_decoder/quadratic_residue.c:26-36
QR_16_7 = BlockCode(
    "qr_16_7", 16, 7,
    (
        0b0111100100000000,
        0b0011110010000000,
        0b1001111001000000,
        0b0011011000100000,
        0b0110001000010000,
        0b1100100000001000,
        0b1110010000000100,
        0b1111001000000010,
        0b1010111000000001,
    ),
    correct_bits=2,
)

# POCSAG BCH(31,21) — src/pocsag_decoder/bch_31_21.c:3-14
BCH_31_21 = BlockCode(
    "bch_31_21", 31, 21,
    (
        0b1001010010011110101011000000000,
        0b1101111011010001111110100000000,
        0b1111101111110110010100010000000,
        0b0111110111111011001010001000000,
        0b1010101001100011001110000100000,
        0b1100000110101111001100000010000,
        0b0110000011010111100110000001000,
        0b1010010011110101011000000000100,
        0b0101001001111010101100000000010,
        0b0010100100111101010110000000001,
    ),
    correct_bits=2,
)

ALL_CODES = (HAMMING_7_4, HAMMING_13_9, HAMMING_15_11, HAMMING_16_11,
             GOLAY_20_8, GOLAY_24_12, QR_16_7, BCH_31_21)
