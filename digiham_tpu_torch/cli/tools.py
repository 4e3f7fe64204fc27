"""The ten pipe-composable tools (reference src/*/\\*_cli.cpp; port of
``digiham_tpu/cli/tools.py``).

Same stream dtypes and flags as the JAX package's tools; the installed
scripts carry the suffix ``_torch`` (``rrc_filter_torch | ...``), so a
pipeline of examples/*.sh switches packages by adding it. The DSP tools
(``rrc_filter``, ``fsk_demodulator``, ``gfsk_demodulator``,
``digitalvoice_filter``) take ``--backend cuda|cpu|numpy`` (cli/base.py):
on the card ``rrc_filter`` runs kernel K4 on each chunk, the demodulators
kernel K3 through a one-century ``StreamDriver``, and
``digitalvoice_filter`` kernel K6. The decoders and ``mbe_synthesizer`` do
host work only.
"""
from __future__ import annotations

import sys
import threading

import numpy as np

from .base import Cli, DecoderCli, add_backend_argument, backend_device


def _tensor(data: np.ndarray, device):
    """One chunk as a [1, n] tensor on ``device`` (stdin's buffer is
    read-only, so it is copied first)."""
    import torch

    return torch.from_numpy(np.array(data))[None, :].to(device)


class RrcFilterCli(Cli):
    """float -> float RRC filter (src/rrc_filter/rrc_filter_cli.cpp)."""

    name = "rrc_filter"
    description = "root-raised-cosine channel filter"
    in_dtype = np.float32
    out_dtype = np.float32

    def add_arguments(self, parser):
        parser.add_argument("-n", "--narrow", action="store_true",
                            help="use narrow (6.25 kHz) filter")
        add_backend_argument(parser)

    def setup(self, args):
        from ..dsp.rrc import NARROW_RRC, WIDE_RRC, RrcState, RrcStreamNp

        self.design = NARROW_RRC if args.narrow else WIDE_RRC
        self.device = backend_device(self.name, args.backend)
        if self.device is None:
            self.stream = RrcStreamNp(self.design)
            return
        self.stream = None
        self.state = RrcState.init(1, self.design, device=self.device)

    def process(self, data: np.ndarray) -> bytes:
        if self.stream is not None:
            return self.stream.process(data).tobytes()
        from ..dsp.rrc import rrc_filter

        y, self.state = rrc_filter(_tensor(data, self.device), self.state,
                                   self.design)
        return y[0].cpu().numpy().tobytes()


class _OracleStream:
    """Streaming adapter over the reference-exact per-symbol oracles
    (FskDemodNp/GfskDemodNp): buffers samples, demodulates what's ready,
    trims consumed input. The oracle's ``pos`` only moves forward (the
    advance is ``sps + variance_offset`` with offset in {-1,0,+1} and the
    read window starts at ``pos``), so trimming to ``pos`` is safe."""

    def __init__(self, oracle):
        self.oracle = oracle
        self.buf = np.zeros(0, np.float32)

    def push(self, samples: np.ndarray) -> np.ndarray:
        self.buf = np.concatenate(
            [self.buf, np.asarray(samples, np.float32)])
        out = self.oracle.process(self.buf)
        self.buf = self.buf[self.oracle.pos:]
        self.oracle.pos = 0
        return out


class _DemodCli(Cli):
    in_dtype = np.float32
    out_dtype = np.uint8
    default_sps = 10
    mode = "gfsk"

    def add_arguments(self, parser):
        parser.add_argument("-s", "--samples", type=int,
                            default=self.default_sps,
                            help="samples per symbol")
        add_backend_argument(parser)

    def _setup_driver(self, args, invert: bool):
        """numpy backend: drive the oracle directly (reference-exact per
        symbol). cuda/cpu: the century demod (K3 on the card) through a
        one-channel, one-century StreamDriver."""
        from ..dsp.demod import (FskDemodNp, GfskDemodNp, demod_init,
                                 fsk_demod_block, gfsk_demod_block)
        from ..runtime.stream import StreamDriver

        self.sps, self.invert = args.samples, invert
        self.oracle = FskDemodNp if self.mode == "fsk" else GfskDemodNp
        device = backend_device(self.name, args.backend)
        if device is None:
            self.driver = None
            self.stream = _OracleStream(self.oracle(self.sps, invert=invert))
            return

        def demod(block, state, n_centuries):
            if self.mode == "fsk":
                return fsk_demod_block(block, state, n_centuries, self.sps,
                                       invert)
            return gfsk_demod_block(block, state, n_centuries, self.sps)

        self.driver = StreamDriver(1, self.sps, demod,
                                   demod_init(1, device=device),
                                   n_centuries=1, device=device)

    def process(self, data: np.ndarray) -> bytes:
        if self.driver is None:
            return self.stream.push(data).astype(np.uint8).tobytes()
        blocks = self.driver.push(np.asarray(data, np.float32)[None, :])
        return b"".join(b[0].astype(np.uint8).tobytes() for b in blocks)

    def flush(self) -> bytes:
        """EOF: the device path needs full centuries; demodulate the
        buffered tail with the reference-exact per-symbol oracle seeded
        from the (century-aligned) device carry, copied to the host, so the
        tool loses only the reference's own sps+1 lookahead at end of
        input. The numpy backend already consumed to within that
        lookahead."""
        if self.driver is None:
            return b""
        drv = self.driver
        st = drv.state
        o = self.oracle(drv.sps, invert=self.invert)
        o.pos = int(st.pos.cpu()[0])
        o.variance_offset = int(st.offset.cpu()[0])
        o.volume_rb = st.volume_ring[0].cpu().numpy().astype(
            np.float32).copy()
        tail = drv.buffer.data[0, :drv.buffer.fill]
        return o.process(tail).astype(np.uint8).tobytes()


class FskDemodulatorCli(_DemodCli):
    """2FSK (src/fsk_demodulator/fsk_demodulator_cli.cpp), default 40 sps."""

    name = "fsk_demodulator"
    description = "2FSK demodulator (bits out)"
    default_sps = 40
    mode = "fsk"

    def add_arguments(self, parser):
        super().add_arguments(parser)
        parser.add_argument("-i", "--invert", action="store_true",
                            help="invert bit polarity")

    def setup(self, args):
        self._setup_driver(args, args.invert)


class GfskDemodulatorCli(_DemodCli):
    """4FSK (src/gfsk_demodulator/gfsk_demodulator_cli.cpp), 10 sps."""

    name = "gfsk_demodulator"
    description = "4FSK (GFSK/C4FM) demodulator (dibits out)"
    default_sps = 10

    def setup(self, args):
        self._setup_driver(args, False)


class DigitalVoiceFilterCli(Cli):
    """s16 audio post filter (src/digitalvoice_filter/)."""

    name = "digitalvoice_filter"
    description = "200-3400 Hz bandpass for digital voice audio"
    in_dtype = np.int16
    out_dtype = np.int16

    def add_arguments(self, parser):
        add_backend_argument(parser)

    def setup(self, args):
        from ..dsp.audio import DigitalVoiceFilterNp, DigitalVoiceState

        self.device = backend_device(self.name, args.backend)
        if self.device is None:
            self.oracle = DigitalVoiceFilterNp()
            return
        self.oracle = None
        self.state = DigitalVoiceState.init(1, device=self.device)

    def process(self, data: np.ndarray) -> bytes:
        if self.oracle is not None:
            return self.oracle.process(data).tobytes()
        from ..dsp.audio import digitalvoice_filter

        y, self.state = digitalvoice_filter(_tensor(data, self.device),
                                            self.state)
        return y[0].cpu().numpy().tobytes()


class DmrDecoderCli(DecoderCli):
    """(src/dmr_decoder/dmr_cli.cpp) with runtime slot-filter control and
    the opt-in RS(12,9) check of the voice LC header (``--rs129``; the JAX
    tool reads ``DIGIHAM_DMR_RS129`` for it)."""

    name = "dmr_decoder"
    description = "DMR decoder (dibits in, voice frames out)"
    rs129 = False

    def make_decoder(self):
        from ..protocols.dmr import make_decoder
        return make_decoder(rs129=self.rs129)

    def add_arguments(self, parser):
        super().add_arguments(parser)
        parser.add_argument("-c", "--control-fifo", metavar="PATH",
                            help="read slot filter commands (0-3) from "
                                 "this fifo")
        parser.add_argument("--rs129", action="store_true",
                            help="check and correct the voice LC header's "
                                 "RS(12,9) parity; drop a header it cannot "
                                 "correct (the reference ignores the "
                                 "parity)")

    def setup(self, args):
        self.rs129 = args.rs129
        super().setup(args)
        if args.control_fifo:
            t = threading.Thread(target=self._fifo_loop,
                                 args=(args.control_fifo,), daemon=True)
            t.start()

    def _fifo_loop(self, path):
        """(dmr_cli.cpp:57-78)"""
        try:
            with open(path, "r") as f:
                for line in f:
                    line = line.strip()
                    if line.isdigit():
                        flt = int(line)
                        if 0 <= flt <= 3:
                            self.decoder.set_slot_filter(flt)
                        else:
                            print(f"invalid slot filter: {flt}",
                                  file=sys.stderr)
        except OSError as e:
            print(f"error reading control fifo: {e}", file=sys.stderr)


class YsfDecoderCli(DecoderCli):
    name = "ysf_decoder"
    description = "YSF decoder"

    def make_decoder(self):
        from ..protocols.ysf import make_decoder
        return make_decoder()


class DstarDecoderCli(DecoderCli):
    name = "dstar_decoder"
    description = "D-Star decoder (bits in)"

    def make_decoder(self):
        from ..protocols.dstar import make_decoder
        return make_decoder()


class NxdnDecoderCli(DecoderCli):
    name = "nxdn_decoder"
    description = "NXDN decoder"

    def make_decoder(self):
        from ..protocols.nxdn import make_decoder
        return make_decoder()


class PocsagDecoderCli(DecoderCli):
    name = "pocsag_decoder"
    description = "POCSAG pager decoder (bits in, messages out)"

    def add_arguments(self, parser):
        pass  # POCSAG writes messages into the payload stream; no fifo

    def setup(self, args):
        self.decoder = self.make_decoder()

    def make_decoder(self):
        from ..protocols import pocsag
        return pocsag.make_decoder()


class MbeSynthesizerCli(Cli):
    """(src/mbe_synthesizer/cli.cpp): AMBE frames in -> s16 PCM out via
    codecserver; --yaesu enables in-stream mode switching. At the end of
    its input it waits for the speech of every frame it shipped (up to 5 s)
    before it exits."""

    name = "mbe_synthesizer"
    description = "MBE voice synthesizer (requires codecserver)"
    in_dtype = np.uint8
    out_dtype = np.int16

    def add_arguments(self, parser):
        parser.add_argument("-y", "--yaesu", action="store_true",
                            help="YSF mode (in-stream codec switching)")
        parser.add_argument("-d", "--dstar", action="store_true",
                            help="D-Star compatible codec")
        parser.add_argument("-s", "--server",
                            default="/tmp/codecserver.sock",
                            help="codecserver unix path or host:port")
        parser.add_argument("-t", "--test", action="store_true",
                            help="test if codecserver can supply AMBE")

    def setup(self, args):
        from ..codec import (ControlWordMode, DynamicMode, MbeSynthesizer,
                             TableMode)
        from ..codec.modes import (DMR_NXDN_TABLE_INDEX,
                                   DSTAR_CONTROL_WORDS, ysf_mode_for)
        server = args.server
        if ":" in server and "/" not in server:
            host, port = server.rsplit(":", 1)
            synth = MbeSynthesizer(host, int(port),
                                   pcm_sink=self._pcm_out)
        else:
            synth = MbeSynthesizer(server, pcm_sink=self._pcm_out)
        if args.test:
            ok = synth.has_ambe_codec()
            print("server response ok" if ok else "no ambe codec",
                  file=sys.stderr)
            synth.close()
            raise SystemExit(0 if ok else 1)
        if args.yaesu:
            synth.set_mode(DynamicMode(ysf_mode_for))
        elif args.dstar:
            synth.set_mode(ControlWordMode(DSTAR_CONTROL_WORDS))
        else:
            synth.set_mode(TableMode(DMR_NXDN_TABLE_INDEX))
        self.synth = synth

    @staticmethod
    def _pcm_out(pcm: bytes) -> None:
        sys.stdout.buffer.write(pcm)
        sys.stdout.buffer.flush()

    def process(self, data: np.ndarray) -> bytes:
        self.synth.process(data.tobytes())
        return b""  # PCM flows via the reader-thread sink

    def flush(self) -> bytes:
        self.synth.drain()
        self.synth.close()
        return b""


def rrc_filter_main():
    return RrcFilterCli().main()


def fsk_demodulator_main():
    return FskDemodulatorCli().main()


def gfsk_demodulator_main():
    return GfskDemodulatorCli().main()


def digitalvoice_filter_main():
    return DigitalVoiceFilterCli().main()


def dmr_decoder_main():
    return DmrDecoderCli().main()


def ysf_decoder_main():
    return YsfDecoderCli().main()


def dstar_decoder_main():
    return DstarDecoderCli().main()


def nxdn_decoder_main():
    return NxdnDecoderCli().main()


def pocsag_decoder_main():
    return PocsagDecoderCli().main()


def mbe_synthesizer_main():
    return MbeSynthesizerCli().main()
