"""The smoke streams: committed fixtures of DMR, YSF, NXDN, D-Star and
POCSAG traffic with the JAX package's decode of it, and the recipes that
turn them into I/Q planes or FM audio.

``data/<protocol>_smoke.npz`` holds, for each of a few stream variants,
the TX symbols (4FSK dibits built with the test suite's frame
synthesizers: dotting, then frames on the receiver's frame grid; 2FSK bits
of D-Star calls or POCSAG batches), the seed of its noise floor, and the
JAX package's CPU outputs for the stream run in ``STEPS`` chained blocks:
DMR through ``DmrPipeline.step_iq_planes`` on the I/Q planes, YSF, NXDN
and the 2FSK ``FskPipeline`` through their pipelines' ``step`` on the FM
audio (NXDN followed by ``nxdn_decode_frames`` on the block's 192-symbol
frames). ``tests/test_torch_pipeline_{dmr,ysf,nxdn,fsk}.py`` rebuild and
check them.

``data/{dmr,ysf,nxdn,dstar,pocsag}_bank_smoke.npz`` are the streaming
banks' fixtures: the TX symbols of a few stream variants of the protocol
(calls or pages with their metadata, the rarer frame types, symbol errors,
an idle channel of noise, and a call that runs into the un-stepped tail,
so that ``flush`` emits bytes), the push chunk sizes, and per variant the
voice (or message) bytes and the metadata event string the JAX package's
``TrackedChannelBank`` produced from the FM audio on the CPU.
``tests/test_torch_tracked_bank{,_ysf,_nxdn,_dstar,_pocsag}.py`` rebuild
and check them.

``data/cli_smoke.npz`` holds the command line's: per example chain of
examples/*.sh (:data:`CLI_CHAINS`, each fed one variant of a bank
fixture's stream), the output of every stage as the JAX package's tools
gave it on the CPU (filtered audio, symbols, decoder bytes, the metadata
file; for the voice chains the PCM of ``mbe_synthesizer`` against a codec
stand-in and that PCM through ``digitalvoice_filter``), the JAX post-filter
of :func:`voice_pcm` and, for the bank width, the JAX post-filter of the
PCM the stand-in gives for each ``dmr_bank`` variant's voice bytes.
``tests/test_torch_cli.py`` rebuilds and checks it. :class:`CodecStandIn`
is that stand-in: a loopback codecserver on a unix socket.

Blocks are chained the way a stream runtime chains them: block ``s``
starts ``s * advance`` samples into the stream; ``advance`` is below the
fewest samples a step consumes, so the demod's read position stays inside
the next block. The carries of the next block are recomputed from the
samples before its origin (the counterpart of
digiham_tpu/runtime/stream.py::rrc_rebase_history): exactly ``ntaps-1``
samples of RRC history, and on the raw-IQ path the last I/Q sample.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import threading
from pathlib import Path

import numpy as np

STEPS = 3
FS = 48000.0
LEVELS = (1 / 3, 1.0, -1 / 3, -1.0)  # 4FSK, indexed by dibit value
NOISE_SIGMA = 0.02  # per I/Q component, on unit-amplitude I/Q
FM_SCALE = 5000.0


@dataclasses.dataclass(frozen=True)
class Stream:
    """One protocol's smoke stream: its bank geometry (the JAX package's
    own block sizes) and the output fields its fixture pins down."""

    name: str
    sps: int
    n_centuries: int
    frame_size: int
    deviation: float  # Hz at the outer symbol levels
    fields: tuple[str, ...]
    # a bank fixture's samples left for flush(): the row K4 filters there
    flush_tail: int = 0
    levels: tuple[float, ...] = LEVELS  # FM deviation per symbol value
    # Gaussian pulse shaping of the frequency (bandwidth-time product), or
    # None for rect pulses. A 2FSK stream needs it: the demod's timing
    # locks onto the column of least variance, the symbol transition, and
    # a rect pulse has none, so its sampling point would walk off.
    bt: float | None = None

    @property
    def fixture(self) -> Path:
        return (Path(__file__).resolve().parent / "data"
                / f"{self.name}_smoke.npz")

    @property
    def symbols_per_block(self) -> int:
        return self.n_centuries * 100

    @property
    def advance(self) -> int:
        """Fewest samples one step consumes: every century may slew back
        by one."""
        return self.n_centuries * 100 * self.sps - self.n_centuries

    @property
    def block_len(self) -> int:
        """Covers the read position (each step may leave it 2 samples per
        century further in after rebasing) plus n_centuries * (100 * sps
        + 1) + 1, rounded up to a multiple of 128."""
        need = (self.n_centuries * (100 * self.sps + 1) + 1
                + 2 * STEPS * self.n_centuries)
        return -(-need // 128) * 128

    @property
    def stream_len(self) -> int:
        return (STEPS - 1) * self.advance + self.block_len


DMR = Stream("dmr", 10, 16, 144, 1944.0,
             ("dibits", "voice_payload", "sync_type", "slot_type_ok",
              "data_type", "bptc_data", "bptc_ok"))
YSF = Stream("ysf", 10, 10, 480, 1944.0,
             ("dibits", "sync_dist", "fich_data", "fich_ok", "vd2_voice",
              "vd2_dch", "vd2_dch_ok"))
NXDN = Stream("nxdn", 20, 4, 192, 1050.0,
              ("dibits", "sync_dist", "lich_byte", "lich_ok",
               "sacch_structure", "sacch_bits", "sacch_ok", "voice0",
               "voice1", "facch_mtype0", "facch_mtype1", "facch_ok0",
               "facch_ok1"))


def _iq(stream: Stream, tx_dibits: np.ndarray, noise_seeds,
        n: int | None = None) -> np.ndarray:
    """[V, N] symbols -> complex128 I/Q [V, n] (``stream_len`` when ``n``
    is omitted): FSK at ``sps`` samples per symbol, ``levels * deviation``
    Hz (rect pulses, Gaussian ones with ``bt``), continuous phase, plus
    complex Gaussian noise seeded per row."""
    if n is None:
        n = stream.stream_len
    levels = np.asarray(stream.levels)
    freq = np.repeat(levels[np.asarray(tx_dibits)], stream.sps,
                     axis=-1)[:, :n] * stream.deviation
    if stream.bt is not None:
        sigma = stream.sps * np.sqrt(np.log(2.0)) / (2 * np.pi * stream.bt)
        t = np.arange(-int(np.ceil(3 * sigma)), int(np.ceil(3 * sigma)) + 1)
        pulse = np.exp(-0.5 * (t / sigma) ** 2)
        pulse /= pulse.sum()
        freq = np.stack([np.convolve(row, pulse, "same") for row in freq])
    iq = np.exp(1j * 2 * np.pi * np.cumsum(freq, axis=-1) / FS)
    for v, seed in enumerate(noise_seeds):
        noise = np.random.default_rng(int(seed)).normal(
            0.0, NOISE_SIGMA, (2, n))
        iq[v] += noise[0] + 1j * noise[1]
    return iq


def modulate(stream: Stream, tx_dibits: np.ndarray,
             noise_seeds) -> tuple[np.ndarray, np.ndarray]:
    """[V, N] dibits -> (re, im) [V, stream_len] float32 I/Q planes."""
    iq = _iq(stream, tx_dibits, noise_seeds)
    return iq.real.astype(np.float32), iq.imag.astype(np.float32)


def audio(stream: Stream, tx_dibits: np.ndarray, noise_seeds,
          n: int | None = None) -> np.ndarray:
    """[V, N] dibits -> [V, n] float32 FM audio (``stream_len`` when ``n``
    is omitted), scaled as the RRC expects it: the quadrature discriminator
    of the stream's I/Q (from a first sample of 1+0j), over pi, times
    ``FM_SCALE``."""
    iq = _iq(stream, tx_dibits, noise_seeds, n)
    prev = np.concatenate([np.ones((iq.shape[0], 1)), iq[:, :-1]], axis=-1)
    return (np.angle(iq * np.conj(prev)) / np.pi * FM_SCALE).astype(
        np.float32)


# 2FSK: bit 1 above the centre for D-Star, below it for POCSAG (its
# pipeline slices inverted), Gaussian pulses of BT 0.5 (D-Star's GMSK);
# the audio step blocks of tools/bench_protocols.py (D-Star 32 centuries,
# POCSAG 8)
DSTAR_LEVELS = (-1.0, 1.0)
POCSAG_LEVELS = (1.0, -1.0)
GMSK_BT = 0.5
DSTAR = Stream("dstar", 10, 32, 96, 1200.0,
               ("dibits", "sync_dist_header_sync", "sync_dist_voice_sync"),
               levels=DSTAR_LEVELS, bt=GMSK_BT)
POCSAG = Stream("pocsag", 40, 8, 32, 4500.0,
                ("dibits", "sync_dist_preamble"), levels=POCSAG_LEVELS,
                bt=GMSK_BT)

# the streaming banks' streams: the bank geometry of the JAX package
# (examples/channel_bank.py); their length, chunks and expected outputs
# come from their fixtures, not from STEPS
DMR_BANK = Stream("dmr_bank", 10, 16, 144, 1944.0, (), flush_tail=12000)
YSF_BANK = Stream("ysf_bank", 10, 10, 480, 1944.0, (), flush_tail=8003)
NXDN_BANK = Stream("nxdn_bank", 20, 4, 192, 1050.0, (), flush_tail=6000)
DSTAR_BANK = Stream("dstar_bank", 10, 4, 96, 1200.0, (), flush_tail=4000,
                    levels=DSTAR_LEVELS, bt=GMSK_BT)
POCSAG_BANK = Stream("pocsag_bank", 40, 4, 32, 4500.0, (), flush_tail=16001,
                     levels=POCSAG_LEVELS, bt=GMSK_BT)


def bank_audio(stream: Stream, fx: dict) -> np.ndarray:
    """A bank fixture's FM audio [V, n] float32, ``n`` the sum of its push
    chunks. An idle variant's carrier is switched off (its dibits are
    ignored): what is left is the discriminator of the noise floor."""
    n = int(fx["chunks"].sum())
    x = audio(stream, fx["tx_dibits"], fx["noise_seeds"], n)
    for v in np.flatnonzero(fx["idle"]):
        noise = np.random.default_rng(int(fx["noise_seeds"][v])).normal(
            0.0, NOISE_SIGMA, (2, n))
        iq = noise[0] + 1j * noise[1]
        prev = np.concatenate([[1.0 + 0j], iq[:-1]])
        x[v] = (np.angle(iq * np.conj(prev)) / np.pi * FM_SCALE).astype(
            np.float32)
    return x


def bank_expected(fx: dict, variant: int) -> tuple[bytes, str]:
    """(voice bytes, metadata event string) of one variant."""
    lo, hi = fx["voice_offsets"][variant:variant + 2]
    voice = fx["voice_bytes"][lo:hi].tobytes()
    lo, hi = fx["event_offsets"][variant:variant + 2]
    return voice, fx["event_bytes"][lo:hi].tobytes().decode()


@contextlib.contextmanager
def function_bits(fx: dict, *modules):
    """While a POCSAG fixture runs: the function bits that open a message
    are the fixture's ``open_function_bits`` (widened to the numeric type
    0 so that its BCD path is exercised; the reference opens 1 and 3
    only), in the port's decoder module and in ``modules`` (other decoder
    modules with an ``OPEN_FUNCTION_BITS``). Restored afterwards. Without
    that key it changes nothing."""
    from .protocols import pocsag

    if "open_function_bits" not in fx:
        yield
        return
    modules = (pocsag, *modules)
    saved = [m.OPEN_FUNCTION_BITS for m in modules]
    for m in modules:
        m.OPEN_FUNCTION_BITS = tuple(int(b) for b in fx["open_function_bits"])
    try:
        yield
    finally:
        for m, bits in zip(modules, saved):
            m.OPEN_FUNCTION_BITS = bits


def launch_counts() -> dict:
    """This process's kernel launches by counter: K1-K3 by front
    (``fm_rrc``, ``rrc``, ``none``), K4 ``fir``, K5 ``viterbi``, K6's IIR
    ``iir`` (its DC blocker is on no bank path)."""
    from .ops import demod_front, fir, recurrence, viterbi

    return dict(demod_front.LAUNCHES, fir=fir.LAUNCHES,
                viterbi=viterbi.LAUNCHES,
                iir=recurrence.LAUNCHES["digitalvoice_iir"])


def reset_launch_counts() -> None:
    from .ops import demod_front, fir, recurrence, viterbi

    for front in demod_front.LAUNCHES:
        demod_front.LAUNCHES[front] = 0
    fir.LAUNCHES = 0
    viterbi.LAUNCHES = 0
    for entry in recurrence.LAUNCHES:
        recurrence.LAUNCHES[entry] = 0


def record_worker(directory: str, bank) -> None:
    """``worker_init`` of a ``MultiStreamBank`` smoke run (bind the
    directory with ``functools.partial``): each channel's metadata events
    append to ``directory/<global channel>.events`` as they are written;
    a ``restore`` (the end of ``prewarm``) starts the worker's kernel
    launch counts again at 0; after ``flush`` they are written to
    ``directory/launches-<global channel 0>.json``."""
    import json

    from .runtime.meta import PipelineMetaWriter

    def append(path, data):
        with open(path, "ab") as f:
            f.write(data)

    for c in range(bank.channels):
        path = os.path.join(directory, f"{bank.first_channel + c}.events")
        bank.set_meta_writer(c, PipelineMetaWriter(
            lambda data, path=path: append(path, data)))
    restore, flush = bank.restore, bank.flush

    def restored(blob):
        restore(blob)
        reset_launch_counts()

    def flushed():
        flush()
        path = os.path.join(directory,
                            f"launches-{bank.first_channel}.json")
        with open(path, "w") as f:
            json.dump(launch_counts(), f)

    bank.restore, bank.flush = restored, flushed


def profile_worker(directory: str, threads, bank) -> None:
    """``worker_init`` of a profiled ``MultiStreamBank`` smoke run (bind
    the first two with ``functools.partial``): the worker's torch threads
    set to ``threads`` unless it is None, and cProfile on from the end of
    ``prewarm`` (its ``restore``) until ``flush``, written to
    ``directory/worker-<global channel 0>.prof``."""
    import cProfile

    import torch

    if threads is not None:
        torch.set_num_threads(threads)
    prof = cProfile.Profile()
    restore, flush = bank.restore, bank.flush

    def restored(blob):
        restore(blob)
        prof.enable()

    def flushed():
        prof.disable()
        prof.dump_stats(os.path.join(
            directory, f"worker-{bank.first_channel}.prof"))
        flush()

    bank.restore, bank.flush = restored, flushed


# a worker's profiler session is taken once: its margins are long
WORKER_MARGIN_S = 2.0


def device_profile_worker(directory: str, bank) -> None:
    """``worker_init`` of a ``MultiStreamBank`` run whose device time is
    measured (bind the directory with ``functools.partial``): a
    ``bench.common.Session`` of torch.profiler from the end of ``prewarm``
    (its ``restore``) until ``flush``, each push waited for. Writes
    ``directory/device-<global channel 0>.json``: the pushes, the worker's
    wall seconds in them, the device kernels and busy milliseconds the
    profiler recorded, and the kernel launches whose device record it
    lost."""
    import json
    import time

    from .bench import common

    run = {"session": None}  # none until the end of prewarm
    restore, push, flush = bank.restore, bank.push, bank.flush

    def restored(blob):
        restore(blob)
        run.update(pushes=0, push_s=0.0, session=common.Session(
            bank.device, WORKER_MARGIN_S))
        run["session"].__enter__()

    def pushed(samples):
        if run["session"] is None:  # prewarm's push
            return push(samples)
        t0 = time.perf_counter()
        push(samples)
        common.synchronize(bank.device)
        run["push_s"] += time.perf_counter() - t0
        run["pushes"] += 1

    def flushed():
        session = run["session"]
        session.__exit__(None, None, None)
        kernels = session.events
        with open(os.path.join(
                directory, f"device-{bank.first_channel}.json"), "w") as f:
            json.dump({"pushes": run["pushes"], "push_s": run["push_s"],
                       "kernels": len(kernels),
                       "busy_ms": sum(e.device_time for e in kernels) / 1e3,
                       "lost": session.lost, "lost_by": session.lost_by},
                      f)
        flush()

    bank.restore, bank.push, bank.flush = restored, pushed, flushed


def read_worker_records(directory: str, channels: int):
    """What :func:`record_worker` left: (event string per channel, launch
    counts summed over the workers)."""
    import json

    events = []
    for c in range(channels):
        path = os.path.join(directory, f"{c}.events")
        events.append(Path(path).read_bytes().decode()
                      if os.path.exists(path) else "")
    launches: dict = {}
    for name in sorted(os.listdir(directory)):
        if name.startswith("launches-"):
            with open(os.path.join(directory, name)) as f:
                for k, v in json.load(f).items():
                    launches[k] = launches.get(k, 0) + v
    return events, launches


def load(stream: Stream) -> dict:
    with np.load(stream.fixture) as f:
        return {k: f[k] for k in f.files}


def rebase_audio(stream: Stream, state, samples, origin: int):
    """Port state for the block starting at sample ``origin`` of the full
    audio ``samples`` [C, stream_len], given the state returned by the
    block that started ``advance`` samples earlier: the RRC history is
    the ``ntaps-1`` raw samples before the origin (a state without an RRC
    keeps ``None``)."""
    from .dsp.demod import DemodState
    from .dsp.rrc import RrcState

    demod = DemodState(state.demod.pos - stream.advance, state.demod.offset,
                       state.demod.volume_ring)
    rrc = None
    if state.rrc is not None:
        halo = state.rrc.history.shape[-1]
        rrc = RrcState(samples[:, origin - halo:origin].clone())
    return dataclasses.replace(state, rrc=rrc, demod=demod)


def rebase_iq(stream: Stream, state, re, im, origin: int):
    """Port state and I/Q carry for the block starting at sample
    ``origin`` of the full planes ``re``/``im`` [C, stream_len]: the RRC
    history is the scaled FM audio of the ``ntaps-1`` samples before the
    origin."""
    from .dsp.fm import fm_discriminator

    halo = state.rrc.history.shape[-1]
    history, _ = fm_discriminator(re[:, origin - halo:origin],
                                  im[:, origin - halo:origin],
                                  re[:, origin - halo - 1],
                                  im[:, origin - halo - 1])
    # the history is the whole of this short audio row: origin = halo
    state = rebase_audio(stream, state, history * FM_SCALE, halo)
    return state, (re[:, origin - 1].clone(), im[:, origin - 1].clone())


# -- the command line -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CliChain:
    """One example chain of examples/*.sh, fed one variant of a bank
    fixture's stream: ``rrc_filter <rrc> | <demod> <demod_args> |
    <decoder>`` (no ``rrc_filter`` when ``rrc`` is None), the decoder with
    ``-f <metadata file>`` where it takes one, then for a voice chain
    ``| mbe_synthesizer | digitalvoice_filter``."""

    name: str
    bank: Stream
    variant: int
    rrc: tuple[str, ...] | None
    demod: str
    demod_args: tuple[str, ...]
    decoder: str
    meta: bool = True
    voice: bool = False

    def tools(self) -> list[tuple[str, tuple[str, ...]]]:
        """(tool, arguments) of each stage; the metadata file is the
        placeholder ``{meta}``."""
        out = [] if self.rrc is None else [("rrc_filter", self.rrc)]
        out.append((self.demod, self.demod_args))
        out.append((self.decoder, ("-f", "{meta}") if self.meta else ()))
        if self.voice:
            out += [("mbe_synthesizer", ("-s", "{server}")),
                    ("digitalvoice_filter", ())]
        return out


CLI_CHAINS = (
    CliChain("dmr", DMR_BANK, 2, (), "gfsk_demodulator", (), "dmr_decoder",
             voice=True),
    CliChain("ysf", YSF_BANK, 3, (), "gfsk_demodulator", (), "ysf_decoder"),
    CliChain("nxdn", NXDN_BANK, 1, ("-n",), "gfsk_demodulator", ("-s", "20"),
             "nxdn_decoder", voice=True),
    CliChain("dstar", DSTAR_BANK, 0, None, "fsk_demodulator", ("-s", "10"),
             "dstar_decoder"),
    CliChain("pocsag", POCSAG_BANK, 7, None, "fsk_demodulator",
             ("-i", "-s", "40"), "pocsag_decoder", meta=False),
)
CLI_FIXTURE = Path(__file__).resolve().parent / "data" / "cli_smoke.npz"
# the post-filter's own input: speech-level PCM (sigma 3,000) at 8 kHz with
# a 500 Hz square wave at +-32,000 in the middle (it saturates), long
# enough for two of the tool's 32,768-sample chunks
VOICE_SAMPLES = 40000
VOICE_SEED = 8000
# the codec stand-in's framing: channel bytes per codec (a table index or
# control words), and the audio bytes of a speech frame
TABLE_FRAMING = {"33": 9, "34": 7}
DSTAR_RATEP_PREFIX = "0130"
AUDIO_BYTES = 320


def cli_audio(chain: CliChain) -> np.ndarray:
    """The chain's input: its bank variant's FM audio, float32 [n]."""
    fx = load(chain.bank)
    v = chain.variant
    one = {"tx_dibits": fx["tx_dibits"][v:v + 1],
           "noise_seeds": fx["noise_seeds"][v:v + 1],
           "idle": fx["idle"][v:v + 1], "chunks": fx["chunks"]}
    return bank_audio(chain.bank, one)[0]


def voice_pcm() -> np.ndarray:
    """Speech-level PCM with an overdriven stretch, int16 [VOICE_SAMPLES]."""
    rng = np.random.default_rng(VOICE_SEED)
    x = rng.normal(0.0, 3000.0, VOICE_SAMPLES)
    lo, hi = VOICE_SAMPLES // 2, VOICE_SAMPLES // 2 + 4000
    x[lo:hi] = np.where((np.arange(hi - lo) // 8) % 2, 32000.0, -32000.0)
    return np.clip(x, -32768, 32767).astype(np.int16)


def stand_in_speech(voice: bytes, channel_bytes: int = 9) -> bytes:
    """The PCM bytes :class:`CodecStandIn` answers a stream of channel
    frames with: each whole frame's bytes twice."""
    n = len(voice) - len(voice) % channel_bytes
    return b"".join(voice[i:i + channel_bytes] * 2
                    for i in range(0, n, channel_bytes))


def bank_voice_pcm(voices) -> np.ndarray:
    """The stand-in's PCM for each channel's voice bytes as one int16
    [channels, T] block, each row zero-padded to the longest."""
    rows = [np.frombuffer(stand_in_speech(v), np.int16) for v in voices]
    out = np.zeros((len(rows), max(len(r) for r in rows)), np.int16)
    for c, r in enumerate(rows):
        out[c, :len(r)] = r
    return out


class CodecStandIn:
    """A loopback codecserver stand-in on a unix socket, for running the
    voice chains without a codec: it speaks the framed-Any dialect of
    ``codec/proto.py`` as the test suite's mock server does. It greets with
    a Handshake (protocol 1.0), answers a Check with OK, a Request or a
    Renegotiation with OK and the codec's framing (:data:`TABLE_FRAMING`;
    control words: 9 channel bytes for D-Star's, 18 for any other), and a
    ChannelData frame with SpeechData of the frame's bytes twice. Each
    connection is served by a thread of its own; ``close`` stops them all.
    """

    def __init__(self, path: str):
        self.path = path
        if os.path.exists(path):
            os.unlink(path)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(path)
        self._listener.listen(64)
        self._listener.settimeout(0.1)
        self._running = True
        self._conns: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._accept = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._accept.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def _framing(args: dict):
        from .codec import proto

        if "index" in args:
            return proto.FramingHint(TABLE_FRAMING[args["index"]],
                                     AUDIO_BYTES)
        dstar = args.get("ratep", "").startswith(DSTAR_RATEP_PREFIX)
        return proto.FramingHint(9 if dstar else 18, AUDIO_BYTES)

    def _accept_loop(self):
        while self._running:
            try:
                sock, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            sock.settimeout(None)
            t = threading.Thread(target=self._serve, args=(sock,),
                                 daemon=True)
            with self._lock:
                self._conns.append(sock)
                self._threads.append(t)
            t.start()

    def _serve(self, sock):
        from .codec import proto
        from .codec.mbe import _Connection

        conn = _Connection(sock)
        try:
            conn.send_message(proto.Handshake("stand-in", "1.0"))
            while True:
                msg = conn.receive_message()
                if msg is None:
                    break
                if isinstance(msg, proto.Check):
                    conn.send_message(proto.Response(proto.STATUS_OK))
                elif isinstance(msg, (proto.Request, proto.Renegotiation)):
                    conn.send_message(proto.Response(
                        proto.STATUS_OK,
                        framing=self._framing(msg.settings.args)))
                elif isinstance(msg, proto.ChannelData):
                    conn.send_message(proto.SpeechData(msg.data * 2))
        except OSError:
            pass  # the client went away mid-reply
        finally:
            conn.close()

    def close(self):
        self._running = False
        self._accept.join(timeout=5.0)
        self._listener.close()
        with self._lock:
            conns, threads = list(self._conns), list(self._threads)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in threads:
            t.join(timeout=5.0)
        if os.path.exists(self.path):
            os.unlink(self.path)
