"""MBE voice synthesizer bridge to an external codecserver daemon.

Host-side equivalent of the reference MbeSynthesizer
(src/mbe_synthesizer/mbe_synthesizer.cpp): connects over a unix or TCP
socket (5 s timeouts), performs the Handshake/version check, negotiates an
AMBE codec via Request (table ``index`` or ``ratep`` control words), then
streams packed channel frames in and receives s16 PCM SpeechData on a
reader thread. Dynamic modes (YSF) read one leading mode byte per frame
and renegotiate the codec mid-stream, synchronized on a condition variable
waiting for the Response carrying new framing (mbe_synthesizer.cpp:288-324).

The voice codec itself is proprietary and stays on the host: this
component is the pipeline's host-side egress. Without a running
codecserver the class raises ConnectionError_ on construction; tests
exercise the full protocol against a loopback mock server
(``digiham_tpu_torch.smoke.CodecStandIn`` is one). Port of
``digiham_tpu/codec/mbe.py``; :meth:`MbeSynthesizer.drain` is the port's
own (the command-line tool waits for the speech still in flight at the end
of its input).
"""
from __future__ import annotations

import socket
import threading
from typing import Callable, Optional

from . import proto
from .modes import ControlWordMode, DynamicMode, Mode, TableMode

DEFAULT_UNIX_PATH = "/tmp/codecserver.sock"
PROTOCOL_VERSION = "1.0"


class Error(RuntimeError):
    pass


class ConnectionError_(Error):
    pass


class ProtocolError(Error):
    pass


class VersionError(Error):
    pass


class ServerError(Error):
    pass


class FramingError(Error):
    pass


class _Connection:
    """Framed-Any message transport (codecserver Connection equivalent)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._rbuf = b""
        self._wlock = threading.Lock()

    def send_message(self, msg) -> None:
        with self._wlock:
            self.sock.sendall(proto.frame_message(msg))

    def receive_message(self):
        """Blocking read of one Any-framed message; None on EOF."""
        while True:
            # try to parse a varint length from the buffer
            msg = self._try_parse()
            if msg is not _INCOMPLETE:
                return msg
            try:
                chunk = self.sock.recv(65536)
            except OSError:
                return None
            if not chunk:
                return None
            self._rbuf += chunk

    def _try_parse(self):
        buf = self._rbuf
        if not buf:
            return _INCOMPLETE
        try:
            length, pos = proto.read_varint(buf, 0)
        except IndexError:
            return _INCOMPLETE
        if len(buf) < pos + length:
            return _INCOMPLETE
        payload = buf[pos:pos + length]
        self._rbuf = buf[pos + length:]
        return proto.unpack_any(payload)

    def is_compatible(self, version: str) -> bool:
        """Major-version check (codecserver Connection::isCompatible)."""
        if not version:
            return False
        return version.split(".")[0] == PROTOCOL_VERSION.split(".")[0]

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


_INCOMPLETE = object()


def _mode_args(mode: Mode) -> dict:
    if isinstance(mode, TableMode):
        return {"index": str(mode.get_index())}
    if isinstance(mode, ControlWordMode):
        return {"ratep": mode.get_cwds_as_string()}
    return {}


class MbeSynthesizer:
    """Channel-frame bytes in -> s16 PCM out via codecserver."""

    def __init__(self, server: str | socket.socket = DEFAULT_UNIX_PATH,
                 port: Optional[int] = None,
                 pcm_sink: Optional[Callable[[bytes], None]] = None,
                 max_buffered_pcm: int = 1 << 20):
        """server: unix path, host (with port), or a connected socket.
        pcm_sink: called from the reader thread with raw s16le PCM bytes;
        if None, PCM accumulates in ``read_pcm()``'s internal buffer.
        """
        if isinstance(server, socket.socket):
            sock = server
        elif port is not None:
            sock = self._connect_tcp(server, port)
        else:
            sock = self._connect_unix(server)
        self.connection = _Connection(sock)
        self.mode: Optional[Mode] = None
        self.current_mode: Optional[Mode] = None
        self.dynamic_mode = False
        self.framing = proto.FramingHint()
        self._framing_cv = threading.Condition()
        self._reader: Optional[threading.Thread] = None
        self._run = True
        self._pcm_sink = pcm_sink
        self._pcm_buffer = bytearray()
        self._pcm_lock = threading.Lock()
        self._max_buffered = max_buffered_pcm
        self._pending = b""
        # frames shipped and speech frames received, for drain()
        self._speech_cv = threading.Condition()
        self._sent = 0
        self._received = 0
        self._eof = False
        self._handshake()

    # -- connection -----------------------------------------------------
    @staticmethod
    def _connect_unix(path: str) -> socket.socket:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(5.0)
        try:
            sock.connect(path)
        except OSError as e:
            raise ConnectionError_(f"connection failure: {e}") from e
        sock.settimeout(None)
        return sock

    @staticmethod
    def _connect_tcp(host: str, port: int) -> socket.socket:
        try:
            sock = socket.create_connection((host, port), timeout=5.0)
        except OSError as e:
            raise ConnectionError_(f"could not connect to server: {e}") from e
        sock.settimeout(None)
        return sock

    # -- protocol -------------------------------------------------------
    def _handshake(self) -> None:
        message = self.connection.receive_message()
        if message is None:
            raise ProtocolError("no handshake")
        if not isinstance(message, proto.Handshake):
            raise ProtocolError("unexpected message")
        if not self.connection.is_compatible(message.protocol_version):
            raise VersionError("server protocol version is incompatible")

    def has_ambe_codec(self) -> bool:
        """Live capability check (mbe_synthesizer.cpp:160-182)."""
        self.connection.send_message(proto.Check("ambe"))
        message = self.connection.receive_message()
        if message is None:
            raise ProtocolError("no response to codec check")
        if not isinstance(message, proto.Response):
            raise ProtocolError("response error")
        return message.result == proto.STATUS_OK

    def set_mode(self, mode: Mode) -> None:
        self.mode = mode
        self.dynamic_mode = isinstance(mode, DynamicMode)
        self._request()
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _request(self) -> None:
        self.current_mode = self.mode
        if isinstance(self.mode, DynamicMode):
            self.current_mode = self.mode.get_mode_for(0)
        request = proto.Request(
            "ambe",
            proto.Settings(args=_mode_args(self.current_mode)))
        self.connection.send_message(request)
        message = self.connection.receive_message()
        if message is None:
            raise ProtocolError("no response to codec request")
        if not isinstance(message, proto.Response):
            raise ProtocolError("response error")
        if message.result != proto.STATUS_OK:
            raise ServerError(message.message)
        if message.framing is None:
            raise FramingError("framing info is not available")
        self.framing = message.framing

    # -- steady state ---------------------------------------------------
    def channel_bytes(self) -> int:
        return self.framing.channel_bytes

    def process(self, data: bytes) -> int:
        """Consume as many frames as available from ``data`` (+ carry);
        returns the number of frames shipped. In dynamic mode each frame
        is preceded by one mode byte (mbe_synthesizer.cpp:236-249)."""
        self._pending += data
        shipped = 0
        while True:
            buf = self._pending
            offset = 0
            if self.dynamic_mode:
                if len(buf) < 1:
                    break
                code = buf[0]
                offset = 1
                new_mode = self.mode.get_mode_for(code)
                if new_mode is not None and len(buf) >= 1:
                    self._set_dynamic_mode(new_mode)
            nbytes = self.framing.channel_bytes
            if len(buf) < offset + nbytes:
                break
            frame = buf[offset:offset + nbytes]
            self._pending = buf[offset + nbytes:]
            self.connection.send_message(proto.ChannelData(frame))
            with self._speech_cv:
                self._sent += 1
            shipped += 1
        return shipped

    def _set_dynamic_mode(self, mode: Mode) -> None:
        """(mbe_synthesizer.cpp:288-324)"""
        if self.current_mode is mode or self.current_mode == mode:
            return
        reneg = proto.Renegotiation(
            proto.Settings(args=_mode_args(mode)))
        with self._framing_cv:
            self.connection.send_message(reneg)
            if not self._framing_cv.wait(timeout=10.0):
                raise FramingError("timeout waiting for framing information")
        self.current_mode = mode

    def _read_loop(self) -> None:
        """(mbe_synthesizer.cpp:251-286)"""
        while self._run:
            message = self.connection.receive_message()
            if message is None:
                with self._speech_cv:
                    self._eof = True
                    self._speech_cv.notify_all()
                break
            if isinstance(message, proto.SpeechData):
                pcm = message.data
                if self._pcm_sink is not None:
                    self._pcm_sink(pcm)
                else:
                    with self._pcm_lock:
                        if len(self._pcm_buffer) + len(pcm) \
                                > self._max_buffered:
                            import sys
                            print("dropping speech data due to writer "
                                  "overflow", file=sys.stderr)
                        else:
                            self._pcm_buffer.extend(pcm)
                with self._speech_cv:
                    self._received += 1
                    self._speech_cv.notify_all()
            elif isinstance(message, proto.Response):
                if message.framing is not None:
                    self.framing = message.framing
                with self._framing_cv:
                    self._framing_cv.notify_all()
            else:
                import sys
                print("received unexpected message type", file=sys.stderr)

    def drain(self, timeout: float = 5.0) -> bool:
        """Wait until a speech frame has come back for every channel frame
        shipped (a codecserver answers each with one), the server closed
        the connection, or ``timeout`` seconds passed. True when every
        frame was answered."""
        with self._speech_cv:
            self._speech_cv.wait_for(
                lambda: self._received >= self._sent or self._eof, timeout)
            return self._received >= self._sent

    def read_pcm(self) -> bytes:
        """Drain buffered PCM (when no pcm_sink was given)."""
        with self._pcm_lock:
            out = bytes(self._pcm_buffer)
            self._pcm_buffer.clear()
        return out

    def close(self) -> None:
        self._run = False
        self.connection.close()
        if self._reader is not None:
            self._reader.join(timeout=5.0)
            self._reader = None
