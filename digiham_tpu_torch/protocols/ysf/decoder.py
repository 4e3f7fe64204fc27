"""YSF decoder assembly (src/ysf_decoder/ysf_decoder.cpp:7; copy of
``digiham_tpu/protocols/ysf/decoder.py``)."""
from __future__ import annotations

from ...runtime.decoder import Decoder
from .meta import MetaCollector
from .phases import SyncPhase


def make_decoder() -> Decoder:
    return Decoder(SyncPhase(), MetaCollector())
