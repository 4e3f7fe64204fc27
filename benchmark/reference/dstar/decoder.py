"""D-Star decoder assembly (src/dstar_decoder/dstar_decoder.cpp:7-9; copy
of ``digiham_tpu/protocols/dstar/decoder.py``)."""
from __future__ import annotations

from ..decoder import Decoder
from .meta import MetaCollector
from .phases import SyncPhase


def make_decoder() -> Decoder:
    return Decoder(SyncPhase(), MetaCollector())
