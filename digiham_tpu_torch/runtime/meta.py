"""Metadata collection, change detection, serialization and transport.

Host-side equivalent of the reference metadata stack (include/meta.hpp:10-69,
src/lib/meta.cpp): protocol decoders mutate a MetaCollector; on change the
collector serializes ``k1:v1;k2:v2\\n`` and pushes it to a writer (a fifo
file, a pipeline, or any callable sink). ``hold()``/``release()`` coalesce
bursts of updates into one event (src/lib/meta.cpp:71-83).

This is the product's observability surface: stdout stays strictly payload,
metadata flows out-of-band per channel — the same contract OpenWebRX
consumes from the reference. Copy of ``digiham_tpu/runtime/meta.py``.
"""
from __future__ import annotations

import io
from typing import Callable, Optional


class StringSerializer:
    """k:v;k:v\\n serialization. Keys are emitted in sorted order — the
    reference serializes a std::map (src/lib/meta.cpp:8-18), which iterates
    alphabetically; output byte streams must match."""

    @staticmethod
    def serialize(data: dict) -> bytes:
        body = ";".join(f"{k}:{data[k]}" for k in sorted(data))
        # surrogateescape: byte-truncated alias strings may carry split
        # multibyte sequences, which the reference forwards verbatim
        return (body + "\n").encode("utf-8", errors="surrogateescape")


class MetaWriter:
    """Abstract metadata sink (include/meta.hpp:24-33)."""

    def __init__(self, serializer: StringSerializer | None = None):
        self.serializer = serializer or StringSerializer()

    def send_metadata(self, data: dict) -> None:
        raise NotImplementedError


class FileMetaWriter(MetaWriter):
    """Write+flush each event to a file/fifo (src/lib/meta.cpp:42-48)."""

    def __init__(self, file, serializer: StringSerializer | None = None):
        super().__init__(serializer)
        if isinstance(file, (str, bytes)):
            file = open(file, "wb", buffering=0)
            self._owns = True
        else:
            self._owns = False
        self.file = file

    def send_metadata(self, data: dict) -> None:
        payload = self.serializer.serialize(data)
        if isinstance(self.file, io.TextIOBase):
            self.file.write(payload.decode("utf-8"))
        else:
            self.file.write(payload)
        self.file.flush()

    def close(self) -> None:
        if self._owns:
            self.file.close()


class PipelineMetaWriter(MetaWriter):
    """Push serialized events into a downstream byte sink — the equivalent
    of writing into a csdr pipeline (src/lib/meta.cpp:50-57)."""

    def __init__(self, sink: Callable[[bytes], None],
                 serializer: StringSerializer | None = None):
        super().__init__(serializer)
        self.sink = sink

    def send_metadata(self, data: dict) -> None:
        self.sink(self.serializer.serialize(data))


class MetaCollector:
    """Base collector: dirty-flag batching + protocol tagging
    (src/lib/meta.cpp:59-103). Subclasses implement ``collect()`` returning
    the current key-value map; ``get_protocol()`` tags every event."""

    def __init__(self):
        self.writer: Optional[MetaWriter] = None
        self._held = 0
        self._dirty = False

    def set_writer(self, writer: Optional[MetaWriter]) -> None:
        self.writer = writer

    def get_protocol(self) -> str:
        raise NotImplementedError

    def collect(self) -> dict:
        return {"protocol": self.get_protocol()}

    def hold(self) -> None:
        self._held += 1

    def release(self) -> None:
        """Coalesced resend on the last release (src/lib/meta.cpp:76-83)."""
        self._held -= 1
        if self._held == 0:
            if self._dirty:
                self.send_metadata()
            self._dirty = False

    def send_metadata(self) -> None:
        if self.writer is None:
            return
        if self._held:
            self._dirty = True
            return
        self.writer.send_metadata(self.collect())
