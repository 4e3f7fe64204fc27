"""Minimal protobuf wire codec for the codecserver protocol.

The reference links against codecserver's client library, which exchanges
``google.protobuf.Any``-wrapped messages with varint length-delimited
framing over a unix/TCP socket (src/mbe_synthesizer/mbe_synthesizer.cpp).
This module implements just enough of the protobuf wire format (varints,
length-delimited fields, string maps) to speak that dialect without a
protobuf dependency.

Field numbers follow codecserver's ``proto/*.proto`` definitions; they are
centralized in each message's FIELDS table so a mismatch against a
specific codecserver version is a one-line fix.
"""
from __future__ import annotations

import io
from typing import Optional


# ---------------------------------------------------------------- wire ---
def write_varint(out: io.BytesIO, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


def read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire_type: int) -> bytes:
    out = io.BytesIO()
    write_varint(out, (field << 3) | wire_type)
    return out.getvalue()


def emit_string(out: io.BytesIO, field: int, value: bytes | str) -> None:
    if isinstance(value, str):
        value = value.encode()
    out.write(_tag(field, 2))
    write_varint(out, len(value))
    out.write(value)


def emit_uint(out: io.BytesIO, field: int, value: int) -> None:
    out.write(_tag(field, 0))
    write_varint(out, value)


def parse_fields(data: bytes) -> dict[int, list]:
    """Decode a message into {field: [values]}; length-delimited values
    stay bytes, varints stay ints."""
    fields: dict[int, list] = {}
    pos = 0
    while pos < len(data):
        key, pos = read_varint(data, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            value, pos = read_varint(data, pos)
        elif wt == 2:
            ln, pos = read_varint(data, pos)
            value = data[pos:pos + ln]
            pos += ln
        elif wt == 5:
            value = data[pos:pos + 4]
            pos += 4
        elif wt == 1:
            value = data[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        fields.setdefault(field, []).append(value)
    return fields


def emit_map_entry(out: io.BytesIO, field: int, k: str, v: str) -> None:
    entry = io.BytesIO()
    emit_string(entry, 1, k)
    emit_string(entry, 2, v)
    emit_string(out, field, entry.getvalue())


def parse_map(entries: list[bytes]) -> dict[str, str]:
    result = {}
    for e in entries:
        f = parse_fields(e)
        k = f.get(1, [b""])[0].decode()
        v = f.get(2, [b""])[0].decode()
        result[k] = v
    return result


# ------------------------------------------------------------- messages ---
TYPE_URL_PREFIX = "type.googleapis.com/CodecServer.proto."

DIRECTION_ENCODE = 0
DIRECTION_DECODE = 1

STATUS_OK = 0
STATUS_ERROR = 1


class Handshake:
    """proto/handshake.proto: serverVersion=1, protocolVersion=2."""

    NAME = "Handshake"

    def __init__(self, server_version: str = "", protocol_version: str = ""):
        self.server_version = server_version
        self.protocol_version = protocol_version

    def serialize(self) -> bytes:
        out = io.BytesIO()
        if self.server_version:
            emit_string(out, 1, self.server_version)
        if self.protocol_version:
            emit_string(out, 2, self.protocol_version)
        return out.getvalue()

    @classmethod
    def parse(cls, data: bytes) -> "Handshake":
        f = parse_fields(data)
        return cls(f.get(1, [b""])[0].decode(), f.get(2, [b""])[0].decode())


class Settings:
    """proto/request.proto Settings: directions=1 (repeated enum),
    args=2 (map<string,string>)."""

    NAME = "Settings"

    def __init__(self, directions=(DIRECTION_DECODE,), args=None):
        self.directions = list(directions)
        self.args = dict(args or {})

    def serialize(self) -> bytes:
        out = io.BytesIO()
        if self.directions:
            # proto3 packs repeated enums: tag(1, len-delim) + varints —
            # byte-identical to what the C++ protobuf client emits
            packed = io.BytesIO()
            for d in self.directions:
                write_varint(packed, d)
            emit_string(out, 1, packed.getvalue())
        # sorted keys match protobuf's deterministic map serialization
        for k in sorted(self.args):
            emit_map_entry(out, 2, k, self.args[k])
        return out.getvalue()

    @classmethod
    def parse(cls, data: bytes) -> "Settings":
        f = parse_fields(data)
        directions = []
        for v in f.get(1, []):
            if isinstance(v, bytes):  # packed
                pos = 0
                while pos < len(v):
                    d, pos = read_varint(v, pos)
                    directions.append(d)
            else:  # unpacked varint
                directions.append(v)
        return cls(directions, parse_map(f.get(2, [])))


class Request:
    """proto/request.proto: codec=1, settings=2."""

    NAME = "Request"

    def __init__(self, codec: str = "ambe",
                 settings: Optional[Settings] = None):
        self.codec = codec
        self.settings = settings or Settings()

    def serialize(self) -> bytes:
        out = io.BytesIO()
        emit_string(out, 1, self.codec)
        emit_string(out, 2, self.settings.serialize())
        return out.getvalue()

    @classmethod
    def parse(cls, data: bytes) -> "Request":
        f = parse_fields(data)
        return cls(f.get(1, [b""])[0].decode(),
                   Settings.parse(f.get(2, [b""])[0]))


class FramingHint:
    """proto/framing.proto: channelBytes=1, audioBytes=2."""

    NAME = "FramingHint"

    def __init__(self, channel_bytes: int = 0, audio_bytes: int = 0):
        self.channel_bytes = channel_bytes
        self.audio_bytes = audio_bytes

    def serialize(self) -> bytes:
        out = io.BytesIO()
        if self.channel_bytes:
            emit_uint(out, 1, self.channel_bytes)
        if self.audio_bytes:
            emit_uint(out, 2, self.audio_bytes)
        return out.getvalue()

    @classmethod
    def parse(cls, data: bytes) -> "FramingHint":
        f = parse_fields(data)
        return cls(f.get(1, [0])[0], f.get(2, [0])[0])


class Response:
    """proto/response.proto: result=1, message=2, framing=3."""

    NAME = "Response"

    def __init__(self, result: int = STATUS_OK, message: str = "",
                 framing: Optional[FramingHint] = None):
        self.result = result
        self.message = message
        self.framing = framing

    def serialize(self) -> bytes:
        out = io.BytesIO()
        if self.result:  # proto3 omits default-valued scalars
            emit_uint(out, 1, self.result)
        if self.message:
            emit_string(out, 2, self.message)
        if self.framing is not None:
            emit_string(out, 3, self.framing.serialize())
        return out.getvalue()

    @classmethod
    def parse(cls, data: bytes) -> "Response":
        f = parse_fields(data)
        framing = None
        if 3 in f:
            framing = FramingHint.parse(f[3][0])
        return cls(f.get(1, [0])[0], f.get(2, [b""])[0].decode(), framing)


class ChannelData:
    """proto/data.proto: data=1."""

    NAME = "ChannelData"

    def __init__(self, data: bytes = b""):
        self.data = data

    def serialize(self) -> bytes:
        out = io.BytesIO()
        emit_string(out, 1, self.data)
        return out.getvalue()

    @classmethod
    def parse(cls, data: bytes) -> "ChannelData":
        return cls(parse_fields(data).get(1, [b""])[0])


class SpeechData:
    """proto/data.proto: data=1 (s16le PCM)."""

    NAME = "SpeechData"

    def __init__(self, data: bytes = b""):
        self.data = data

    def serialize(self) -> bytes:
        out = io.BytesIO()
        emit_string(out, 1, self.data)
        return out.getvalue()

    @classmethod
    def parse(cls, data: bytes) -> "SpeechData":
        return cls(parse_fields(data).get(1, [b""])[0])


class Renegotiation:
    """proto/request.proto: settings=1."""

    NAME = "Renegotiation"

    def __init__(self, settings: Optional[Settings] = None):
        self.settings = settings or Settings()

    def serialize(self) -> bytes:
        out = io.BytesIO()
        emit_string(out, 1, self.settings.serialize())
        return out.getvalue()

    @classmethod
    def parse(cls, data: bytes) -> "Renegotiation":
        f = parse_fields(data)
        return cls(Settings.parse(f.get(1, [b""])[0]))


class Check:
    """proto/check.proto: codec=1."""

    NAME = "Check"

    def __init__(self, codec: str = "ambe"):
        self.codec = codec

    def serialize(self) -> bytes:
        out = io.BytesIO()
        emit_string(out, 1, self.codec)
        return out.getvalue()

    @classmethod
    def parse(cls, data: bytes) -> "Check":
        return cls(parse_fields(data).get(1, [b""])[0].decode())


MESSAGE_TYPES = {cls.NAME: cls for cls in (
    Handshake, Request, Response, ChannelData, SpeechData, Renegotiation,
    Check)}


# ------------------------------------------------------------------ Any ---
def pack_any(msg) -> bytes:
    """google.protobuf.Any: type_url=1, value=2."""
    out = io.BytesIO()
    emit_string(out, 1, TYPE_URL_PREFIX + msg.NAME)
    emit_string(out, 2, msg.serialize())
    return out.getvalue()


def unpack_any(data: bytes):
    f = parse_fields(data)
    type_url = f.get(1, [b""])[0].decode()
    value = f.get(2, [b""])[0]
    name = type_url.rsplit(".", 1)[-1]
    cls = MESSAGE_TYPES.get(name)
    if cls is None:
        return None
    return cls.parse(value)


def frame_message(msg) -> bytes:
    """Varint length-delimited Any — the on-socket framing."""
    payload = pack_any(msg)
    out = io.BytesIO()
    write_varint(out, len(payload))
    out.write(payload)
    return out.getvalue()
