"""D-Star's CRC over bytes (src/dstar_decoder/crc.cpp:9-16): CRC-16 with
the reflected polynomial 0x8408, the register 0xFFFF at the start and
inverted at the end, each byte least significant bit first (the X.25
CRC). Plain Python, a bit at a time: a message of any length costs one
pass over its bits, and no table is built."""


def crc16_dstar_bytes(data: bytes) -> int:
    """The D-Star CRC of ``data``; 0x906E for ``b"123456789"``."""
    reg = 0xFFFF
    for byte in data:
        reg ^= byte
        for _ in range(8):
            reg = (reg >> 1) ^ 0x8408 if reg & 1 else reg >> 1
    return reg ^ 0xFFFF
