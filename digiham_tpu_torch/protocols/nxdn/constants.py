"""NXDN frame layout and frame sync word, as data only.

Copies of ``digiham_tpu/protocols/nxdn/phases.py``, in a module of
their own so that the device pipeline reads them without the host phase
machines.
"""
import numpy as np

SYNC_SIZE = 10
FRAME_SIZE = 192
# the hunt's hit: a distance <= 2 to the frame sync; the tracked bank's
# fast skip gates on the same bound
SYNC_BOUND = 2

# -3, +1, -3, +3, -3, -3, +3, +3, -1, +3 (nxdn_phase.cpp:16)
FRAME_SYNC = np.array([3, 0, 3, 1, 3, 3, 1, 1, 2, 1], dtype=np.uint8)
