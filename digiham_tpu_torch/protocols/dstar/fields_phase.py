"""Tracked-bank support for D-Star (copy of
``digiham_tpu/protocols/dstar/fields_phase.py``).

Two pieces:

- ``DstarHuntPhase``: the host hunt. Runs the bit-domain sync scan
  (dstar_phase.cpp:40-57) and, when it lands on a header sync, the
  660-bit header decode as well (header.cpp), in a ``bank.hunt.header``
  span while the tracer is on — it reports "locked" only once a voice
  stream begins. While a header decode is pending the ``hunting`` flag is
  False so the bank's device-gated fast skip stands down (a header needs
  the exact current stream position preserved).

- ``DstarFieldsFramePhase``: the steady-state frame machine, equivalent
  transition-for-transition to ``VoicePhase.process``
  (dstar_phase.cpp:59-134) but consuming fields precomputed in batch on
  the device (``pipeline.fsk.dstar_decode_frames``): packed voice bytes,
  descrambled slow-data bytes, terminator and voice-sync distances.
  Returns ``(payload, lost, keep_from)`` per 96-bit frame; a full-length
  terminator consumes 24 bits beyond the frame (keep_from=120), exactly
  like the symbol path.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...runtime.decoder import Output, Phase
from ...runtime.metrics import TRACER
from .phases import HeaderPhase, SyncPhase, VoicePhase


class DstarHuntPhase(Phase):
    def __init__(self, meta=None):
        self.meta = meta
        self.inner: Phase = SyncPhase()

    @property
    def hunting(self) -> bool:
        return isinstance(self.inner, SyncPhase)

    def required_data(self) -> int:
        return self.inner.required_data()

    def process(self, data, output: Output):
        if type(self.inner) is HeaderPhase:
            with TRACER.span("bank.hunt.header"):
                nxt, consumed = self.inner.process(data, output)
        else:
            nxt, consumed = self.inner.process(data, output)
        if nxt is None:
            return None, consumed
        nxt.set_meta_collector(self.meta)
        if isinstance(nxt, VoicePhase):
            self.inner = SyncPhase()
            return nxt, consumed
        self.inner = nxt  # HeaderPhase, or SyncPhase after a failed header
        return None, consumed


@dataclass
class DstarFrameFields:
    voice_bytes: bytes   # 9 bytes, LSB-first packed
    data_bytes: bytes    # 3 descrambled slow-data bytes
    term_full: int       # distance of bits[72:120] to the 48-bit terminator
    term_half: int       # distance of bits[72:96] to its second half
    vsync_dist: int      # distance of bits[72:96] to the voice sync


class DstarFieldsFramePhase:
    """(voice, lost, keep_from) from precomputed frame fields."""

    def __init__(self, meta=None, voice_phase: VoicePhase | None = None):
        vp = voice_phase if isinstance(voice_phase, VoicePhase) \
            else VoicePhase(0)
        vp.set_meta_collector(meta)
        self.vp = vp
        self.meta = meta

    def process_fields(self, f: DstarFrameFields):
        vp = self.vp
        out = f.voice_bytes if vp.sync_count >= 1 else b""
        if f.term_full <= 1 or f.term_half <= 1:
            if self.meta is not None:
                self.meta.reset()
            return out, True, 120  # terminator eats the lookahead too
        if vp._is_sync_due():
            if f.vsync_dist > 1:
                vp.sync_count -= 1
                if vp.sync_count < 0:
                    if self.meta is not None:
                        self.meta.reset()
                    return out, True, 96
            else:
                vp.sync_count = min(vp.sync_count + 1, 3)
                if vp.sync_count > 1 and self.meta is not None:
                    self.meta.set_sync("voice")
            vp._parse_frame_data()
            vp._reset_frames()
        else:
            vp._collect_data_frame(f.data_bytes)
            vp.frame_count += 1
        return out, False, 0
