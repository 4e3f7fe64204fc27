"""Protocol decoder loop: the phase-machine pattern, host side.

Mirrors the reference core runtime (src/lib/decoder.cpp:21-47,
src/lib/phase.hpp:9-17): a ``Decoder`` owns a swappable ``Phase``; each
phase declares its lookahead (``required_data``) and consumes symbols from
the front of a buffer, optionally emitting payload bytes and swapping to a
new phase. The decoder loops while enough symbols are buffered.

Role in the architecture: this is the *control plane* (copy of
``digiham_tpu/runtime/decoder.py``). Phases hold tiny per-channel integer
state (sync counters, slot tracking) and make data-dependent advance
decisions — the part of the reference that doesn't map to fixed-shape
batched device work. A multi-channel host loop over these decoders performs
only O(frames) numpy work per channel while the device does O(samples)
work in batch.
"""
from __future__ import annotations

import numpy as np

from .meta import MetaCollector, MetaWriter


class Phase:
    """One decode state. ``process`` sees the buffered symbol front and
    returns (next_phase | None, consumed):

    - next_phase None = stay (reference: returning ``this``/nullptr)
    - consumed = how many input items to drop from the stream front
    """

    meta: MetaCollector | None = None

    def required_data(self) -> int:
        raise NotImplementedError

    def process(self, data: np.ndarray, output: "Output"):
        raise NotImplementedError

    def set_meta_collector(self, meta: MetaCollector | None) -> None:
        self.meta = meta


class Output:
    """Payload byte sink (the reference's downstream pipe writer)."""

    def __init__(self):
        self._chunks: list[bytes] = []

    def write(self, data: bytes | np.ndarray) -> None:
        if isinstance(data, np.ndarray):
            data = data.astype(np.uint8).tobytes()
        self._chunks.append(bytes(data))

    def drain(self) -> bytes:
        out = b"".join(self._chunks)
        self._chunks.clear()
        return out


class Decoder:
    """Streaming decoder for one channel (src/lib/decoder.cpp:21-47)."""

    def __init__(self, initial_phase: Phase,
                 collector: MetaCollector | None = None):
        self.current_phase = initial_phase
        self.meta_collector = collector
        self.current_phase.set_meta_collector(collector)
        self._buffer = np.zeros(0, dtype=np.uint8)
        self.output = Output()

    def set_meta_writer(self, writer: MetaWriter | None) -> None:
        if self.meta_collector is not None:
            self.meta_collector.set_writer(writer)

    def set_phase(self, phase: Phase) -> None:
        if phase is self.current_phase:
            return
        self.current_phase = phase
        phase.set_meta_collector(self.meta_collector)

    def process(self, symbols: np.ndarray | bytes) -> bytes:
        """Feed new symbols; run phases while lookahead is satisfied;
        return emitted payload bytes."""
        if isinstance(symbols, (bytes, bytearray)):
            symbols = np.frombuffer(bytes(symbols), dtype=np.uint8)
        self._buffer = np.concatenate(
            [self._buffer, np.asarray(symbols, dtype=np.uint8)])
        pos = 0
        n = len(self._buffer)
        while n - pos > self.current_phase.required_data():
            next_phase, consumed = self.current_phase.process(
                self._buffer[pos:], self.output)
            pos += consumed
            if next_phase is not None:
                self.set_phase(next_phase)
        if pos:
            self._buffer = self._buffer[pos:]
        return self.output.drain()
