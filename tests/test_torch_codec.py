"""The port's codecserver bridge (``digiham_tpu_torch/codec``) against the
JAX package's: the same wire bytes for every message the JAX package's
codec tests write (tests/test_proto_wire.py, tests/test_codec.py), each
side parsing the other's; the same modes; and ``MbeSynthesizer`` against
the port's stand-in (``smoke.CodecStandIn``, a unix socket) and the test
suite's mock servers (tests/test_codec.py's over a socketpair,
tests/test_codec_socket.py's over TCP): handshake, the codec check, table
mode, dynamic-mode renegotiation, partial frames, draining, version and
connection failures. Equal means equal bytes."""
import io
import os
import socket
import sys
import tempfile
import threading
import time

import pytest

sys.path.insert(0, os.path.dirname(__file__))

from digiham_tpu.codec import modes as j_modes  # noqa: E402
from digiham_tpu.codec import proto as j_proto  # noqa: E402
from digiham_tpu_torch import smoke  # noqa: E402
from digiham_tpu_torch.codec import (ControlWordMode, DynamicMode,  # noqa: E402
                                     MbeSynthesizer, TableMode, modes,
                                     proto)
from digiham_tpu_torch.codec.mbe import (ConnectionError_,  # noqa: E402
                                         VersionError, _Connection)
from test_codec import MockCodecServer  # noqa: E402
from test_codec_socket import TcpMockServer  # noqa: E402


def _messages(p):
    """Every message the JAX package's codec tests serialize, built with
    the module ``p`` (the port's proto or the JAX package's)."""
    reneg = p.Renegotiation(p.Settings(args={"index": "34"}))
    reneg.settings.directions = [p.DIRECTION_DECODE]
    return {
        "handshake": p.Handshake("codecserver 0.2", "1.0"),
        "handshake_empty": p.Handshake(),
        "request": p.Request("ambe", p.Settings(
            directions=[p.DIRECTION_DECODE],
            args={"index": "33", "ratep": "0130:0763"})),
        "request_index": p.Request("ambe", p.Settings(args={"index": "33"})),
        "request_encode": p.Request("ambe", p.Settings(
            directions=[p.DIRECTION_ENCODE, p.DIRECTION_DECODE], args={})),
        "response_framing": p.Response(p.STATUS_OK,
                                       framing=p.FramingHint(9, 320)),
        "response_error": p.Response(p.STATUS_ERROR, "no such codec"),
        "response_ok": p.Response(p.STATUS_OK),
        "channel_data": p.ChannelData(bytes(range(9))),
        "speech_data": p.SpeechData(b"\x01\x02"),
        "speech_frame": p.SpeechData(b"\x01\x02" * 160),
        "check": p.Check("ambe"),
        "renegotiation": reneg,
        "renegotiation_default": p.Renegotiation(),
    }


NAMES = list(_messages(proto))


@pytest.mark.parametrize("name", NAMES)
def test_wire_bytes_equal(name):
    ours, theirs = _messages(proto)[name], _messages(j_proto)[name]
    assert ours.serialize() == theirs.serialize()
    assert proto.pack_any(ours) == j_proto.pack_any(theirs)
    assert proto.frame_message(ours) == j_proto.frame_message(theirs)


@pytest.mark.parametrize("name", NAMES)
def test_each_side_parses_the_other(name):
    ours, theirs = _messages(proto)[name], _messages(j_proto)[name]
    framed = j_proto.frame_message(theirs)
    length, pos = proto.read_varint(framed, 0)
    back = proto.unpack_any(framed[pos:pos + length])
    assert type(back).__name__ == type(theirs).__name__
    assert back.serialize() == theirs.serialize()
    framed = proto.frame_message(ours)
    length, pos = j_proto.read_varint(framed, 0)
    assert j_proto.unpack_any(framed[pos:pos + length]).serialize() \
        == ours.serialize()


@pytest.mark.parametrize("value", [0, 1, 127, 128, 300, 1 << 20,
                                   (1 << 35) + 7])
def test_varints_equal(value):
    a, b = io.BytesIO(), io.BytesIO()
    proto.write_varint(a, value)
    j_proto.write_varint(b, value)
    assert a.getvalue() == b.getvalue()
    assert proto.read_varint(a.getvalue(), 0) == (value, len(a.getvalue()))


def test_unknown_type_url_is_none():
    out = io.BytesIO()
    proto.emit_string(out, 1, proto.TYPE_URL_PREFIX + "Nothing")
    assert proto.unpack_any(out.getvalue()) is None


def test_modes_equal():
    assert modes.DMR_NXDN_TABLE_INDEX == j_modes.DMR_NXDN_TABLE_INDEX == 33
    assert modes.YSF_DN_TABLE_INDEX == j_modes.YSF_DN_TABLE_INDEX == 34
    assert modes.DSTAR_CONTROL_WORDS == j_modes.DSTAR_CONTROL_WORDS
    assert modes.YSF_FRAME_SIZES == j_modes.YSF_FRAME_SIZES
    assert ControlWordMode(modes.DSTAR_CONTROL_WORDS).get_cwds_as_string() \
        == "0130:0763:4000:0000:0000:0048"
    assert TableMode(33) == TableMode(33) and TableMode(33) != TableMode(34)
    assert hash(TableMode(33)) == hash(TableMode(33))
    d = DynamicMode(lambda c: None)
    assert d == d and d != DynamicMode(lambda c: None)


@pytest.mark.parametrize("code", range(5))
def test_ysf_mode_for(code):
    ours, theirs = modes.ysf_mode_for(code), j_modes.ysf_mode_for(code)
    if theirs is None:
        assert ours is None
    elif isinstance(theirs, j_modes.TableMode):
        assert isinstance(ours, TableMode) and ours.index == theirs.index
    else:
        assert isinstance(ours, ControlWordMode)
        assert ours.get_cwds_as_string() == theirs.get_cwds_as_string()


@pytest.fixture
def stand_in():
    with tempfile.TemporaryDirectory() as tmp, \
            smoke.CodecStandIn(os.path.join(tmp, "codec.sock")) as server:
        yield server


def _mock_pair():
    server = MockCodecServer()
    server.start()
    return server, MbeSynthesizer(server.client_sock)


def _pcm(synth, n, timeout=5.0):
    deadline, pcm = time.monotonic() + timeout, b""
    while len(pcm) < n and time.monotonic() < deadline:
        pcm += synth.read_pcm()
        time.sleep(0.005)
    return pcm


@pytest.mark.parametrize("server", ["stand_in", "mock"])
def test_handshake_and_check(server, stand_in):
    synth = (MbeSynthesizer(stand_in.path) if server == "stand_in"
             else _mock_pair()[1])
    assert synth.has_ambe_codec()
    synth.close()


@pytest.mark.parametrize("server", ["stand_in", "mock"])
def test_table_mode_stream(server, stand_in):
    synth = (MbeSynthesizer(stand_in.path) if server == "stand_in"
             else _mock_pair()[1])
    synth.set_mode(TableMode(33))
    assert synth.channel_bytes() == 9
    assert synth.process(b"\xAB" * 27) == 3
    assert synth.drain()
    assert synth.read_pcm() == b"\xAB" * 54
    synth.close()


@pytest.mark.parametrize("server", ["stand_in", "mock"])
def test_dynamic_mode_renegotiates(server, stand_in):
    synth = (MbeSynthesizer(stand_in.path) if server == "stand_in"
             else _mock_pair()[1])
    synth.set_mode(DynamicMode(modes.ysf_mode_for))
    assert synth.channel_bytes() == 9
    assert synth.process(bytes([2]) + b"\x11" * 7) == 1
    assert synth.channel_bytes() == 7
    assert synth.process(bytes([3]) + b"\x33" * 18) == 1
    assert synth.channel_bytes() == 18
    assert synth.process(bytes([0]) + b"\x22" * 9) == 1
    assert synth.channel_bytes() == 9
    assert synth.drain()
    assert synth.read_pcm() == (b"\x11" * 14 + b"\x33" * 36 + b"\x22" * 18)
    synth.close()


def test_mock_server_sees_the_renegotiation():
    server, synth = _mock_pair()
    synth.set_mode(DynamicMode(modes.ysf_mode_for))
    synth.process(bytes([2]) + b"\x11" * 7)
    assert server.requests == [{"index": "33"}]
    assert server.renegotiations == [{"index": "34"}]
    synth.close()


def test_partial_frames_buffered(stand_in):
    synth = MbeSynthesizer(stand_in.path)
    synth.set_mode(TableMode(33))
    assert synth.process(b"\x01" * 5) == 0
    assert synth.process(b"\x01" * 4) == 1
    synth.close()


def test_dstar_control_words_framing(stand_in):
    synth = MbeSynthesizer(stand_in.path)
    synth.set_mode(ControlWordMode(modes.DSTAR_CONTROL_WORDS))
    assert synth.channel_bytes() == 9
    synth.close()


def test_pcm_sink_receives_speech(stand_in):
    got = []
    synth = MbeSynthesizer(stand_in.path, pcm_sink=got.append)
    synth.set_mode(TableMode(33))
    synth.process(bytes(range(18)))
    assert synth.drain()
    assert b"".join(got) == bytes(range(9)) * 2 + bytes(range(9, 18)) * 2
    synth.close()


def test_tcp_roundtrip():
    server = TcpMockServer()
    server.start()
    synth = MbeSynthesizer("127.0.0.1", server.port)
    synth.set_mode(TableMode(33))
    assert synth.process(b"\x55" * 9) == 1
    assert _pcm(synth, 320) == b"\x03\x04" * 160
    synth.close()


def test_tcp_check():
    server = TcpMockServer()
    server.start()
    synth = MbeSynthesizer("127.0.0.1", server.port)
    assert synth.has_ambe_codec()
    synth.close()


def test_connect_failure_unix(tmp_path):
    with pytest.raises(ConnectionError_):
        MbeSynthesizer(str(tmp_path / "missing.sock"))


def test_connect_failure_tcp():
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    port = listener.getsockname()[1]
    listener.close()  # nothing listens there now
    with pytest.raises(ConnectionError_):
        MbeSynthesizer("127.0.0.1", port)


def test_incompatible_protocol_version():
    ours, theirs = socket.socketpair()

    def greet():
        _Connection(theirs).send_message(proto.Handshake("future", "2.0"))

    t = threading.Thread(target=greet)
    t.start()
    with pytest.raises(VersionError):
        MbeSynthesizer(ours)
    t.join(timeout=5)
    assert not t.is_alive()
    theirs.close()
    ours.close()


def test_drain_returns_when_the_server_closes():
    """A server that takes a frame and hangs up without speech: drain()
    returns False at once, not after its timeout."""
    ours, theirs = socket.socketpair()

    def serve():
        conn = _Connection(theirs)
        conn.send_message(proto.Handshake("mute", "1.0"))
        conn.receive_message()  # the Request
        conn.send_message(proto.Response(proto.STATUS_OK,
                                         framing=proto.FramingHint(9, 320)))
        conn.receive_message()  # a ChannelData, never answered
        conn.close()

    t = threading.Thread(target=serve)
    t.start()
    synth = MbeSynthesizer(ours)
    synth.set_mode(TableMode(33))
    synth.process(b"\x01" * 9)
    start = time.monotonic()
    assert not synth.drain(timeout=5.0)
    assert time.monotonic() - start < 4.0
    t.join(timeout=5)
    assert not t.is_alive()
    synth.close()
