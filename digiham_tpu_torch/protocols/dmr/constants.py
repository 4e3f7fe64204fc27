"""DMR frame layout and sync patterns, as data only.

Copies of ``digiham_tpu/protocols/dmr/phases.py`` (sync words, frame
geometry) and ``digiham_tpu/protocols/dmr/components.py::TACT_POSITIONS``:
their one home in the port, read by the device pipeline and by the host
phase machines alike.
"""
import numpy as np

SYNC_SIZE = 24
CACH_SIZE = 12
FRAME_SIZE = 144
SYNC_OFFSET = 54 + CACH_SIZE  # sync sits mid-frame (dmr_phase.hpp:30-33)
# the hunt's hit: a distance <= 3 to any pattern (dmr_phase.cpp:18-33); the
# tracked bank's fast skip gates on the same bound
SYNC_BOUND = 3

# sync patterns (dmr_phase.cpp:18-33), one dibit per symbol
BS_DATA_SYNC = np.array(
    [3, 1, 3, 3, 3, 3, 1, 1, 1, 3, 3, 1, 1, 3, 1, 1, 3, 1, 3, 3, 1, 1, 3, 1],
    dtype=np.uint8)
BS_VOICE_SYNC = np.array(
    [1, 3, 1, 1, 1, 1, 3, 3, 3, 1, 1, 3, 3, 1, 3, 3, 1, 3, 1, 1, 3, 3, 1, 3],
    dtype=np.uint8)
MS_DATA_SYNC = np.array(
    [3, 1, 1, 1, 3, 1, 1, 3, 3, 3, 1, 3, 1, 3, 3, 3, 3, 1, 1, 3, 1, 1, 1, 3],
    dtype=np.uint8)
MS_VOICE_SYNC = np.array(
    [1, 3, 3, 3, 1, 3, 3, 1, 1, 1, 3, 1, 3, 1, 1, 1, 1, 3, 3, 1, 3, 3, 3, 1],
    dtype=np.uint8)

# CACH bit positions of the 7 TACT bits (cach.cpp:11-32)
TACT_POSITIONS = np.array([0, 4, 8, 12, 14, 18, 22], dtype=np.int32)
