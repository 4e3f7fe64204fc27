"""YSF frame layout, sync word and voice tables, as data only.

Copies of ``digiham_tpu/protocols/ysf/phases.py``, in a module of
their own so that the device pipeline reads them without the host phase
machines.
"""
import numpy as np

SYNC_SIZE = 20
FICH_SIZE = 100
FRAME_SIZE = 480

# D471C9634D as dibits (ysf_phase.hpp:20-22)
YSF_SYNC = np.array(
    [3, 1, 1, 0, 1, 3, 0, 1, 3, 0, 2, 1, 1, 2, 0, 3, 1, 0, 3, 1],
    dtype=np.uint8,
)

TRIBIT_MAJORITY = np.array([0, 0, 0, 1, 0, 1, 1, 1], dtype=np.uint8)

# gr-ysf voice bit output mapping (ysf_phase.hpp:46-51)
V2_VOICE_MAPPING = np.array([
    0, 3, 6, 9, 12, 15, 18, 21, 24, 27, 30, 33, 36, 39, 41, 43, 45, 47,
    1, 4, 7, 10, 13, 16, 19, 22, 25, 28, 31, 34, 37, 40, 42, 44, 46, 48,
    2, 5, 8, 11, 14, 17, 20, 23, 26, 29, 32, 35, 38,
], dtype=np.int32)
