"""NXDN decoder assembly (src/nxdn_decoder/nxdn_decoder.cpp:7; copy of
``digiham_tpu/protocols/nxdn/decoder.py``)."""
from __future__ import annotations

from ..decoder import Decoder
from .meta import MetaCollector
from .phases import SyncPhase


def make_decoder() -> Decoder:
    return Decoder(SyncPhase(), MetaCollector())
