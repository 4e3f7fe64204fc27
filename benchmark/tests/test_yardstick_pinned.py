"""The yardstick pinned: for one seed of each busy cell at the CPU tests'
size, the SHA-256 of the generated traffic and of the reference front's
output (symbols, symbol ends, century starts). The digests were taken
before the front and the traffic learnt the other protocols' settings,
so a change that moves what today's cells read fails here."""
import hashlib

import numpy as np
import pytest
import torch

from benchmark.harness import spec, traffic
from benchmark.reference import dsp
from conftest import small_cell

SEED = 2**31 + 7
PINNED = {
    "dmr_site.busy": (
        "3c0d0b4e447a012754e2d0b7ff42f7aa5d69175bcdfbfe0bd4046c0fb0b23e58",
        "4c08f7086fb84082865f0cb166a2c7827d60d3da44158f556e9a45caa00956e4"),
    "ysf_site.busy": (
        "195162eb3c4ca8c23f284ef4b1de4dba2afd60dd741392f4f1301aad5d1f68e2",
        "9dc306c8af33bc512cd70d1a6f053de5057286d00f9751021f4491e8d68e88cf"),
}


@pytest.mark.parametrize("name", list(PINNED))
def test_traffic_and_front_are_pinned(name):
    want_traffic, want_front = PINNED[name]
    cell = small_cell(name)
    stream = traffic.make(cell, SEED, "cpu")
    assert hashlib.sha256(stream.loop.tobytes()).hexdigest() == want_traffic
    cfg = cell.config
    audio = torch.from_numpy(stream.rows([0, 1, 2, 3], 60000))
    mode, invert = spec.slicer(cell.protocol)
    front = dsp.demodulate(audio, cfg["sps"], cfg["rrc"], mode=mode,
                           invert=invert)
    assert front[0].shape == (4, 5900)
    digest = hashlib.sha256()
    for a in front:
        digest.update(np.ascontiguousarray(a).tobytes())
    assert digest.hexdigest() == want_front
