"""CLI framework: the pipe-composable tool skeleton (src/lib/cli.cpp; port
of ``digiham_tpu/cli/base.py``).

Each tool reads a typed binary stream on stdin and writes its output
stream to stdout, exactly like the reference binaries, so the port's tools
drop into existing shell pipelines (examples/*.sh). Decoder tools add
``-f/--fifo`` for the out-of-band metadata stream (src/lib/cli.cpp:117-141).

The DSP tools take ``--backend``: ``cuda`` (the default: the torch path on
the card, kernels K3, K4 and K6), ``cpu`` (the same code on the CPU, which
runs the kernels' plain versions) or ``numpy`` (the host oracles). No
environment variable chooses it, and ``cuda`` never carries on on the CPU:
without a card the tool exits with a message. Kernel builds are cached by
``ops/build.py``, so there is no compilation cache to enable.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..runtime.meta import FileMetaWriter

BUF_SIZE = 65536
BACKENDS = ("cuda", "cpu", "numpy")


def add_backend_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--backend", choices=BACKENDS, default="cuda",
                        help="cuda: the card (default); cpu: the same code "
                             "on the CPU; numpy: the host oracles")


def backend_device(tool: str, backend: str):
    """The torch device of a DSP backend, None for ``numpy``. ``cuda``
    without a card exits with a message (status 1)."""
    if backend == "numpy":
        return None
    import torch

    if backend == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{tool}: --backend cuda needs an NVIDIA GPU and "
                         "found none; --backend cpu runs the same code on "
                         "the CPU, --backend numpy the host oracles")
    return torch.device(backend)


class Cli:
    """Base tool: argparse + binary stdin->stdout loop."""

    name = "tool"
    description = ""
    in_dtype = np.uint8
    out_dtype = np.uint8

    def add_arguments(self, parser: argparse.ArgumentParser) -> None:
        pass

    def setup(self, args) -> None:
        pass

    def process(self, data: np.ndarray) -> bytes:
        raise NotImplementedError

    def flush(self) -> bytes:
        return b""

    def main(self, argv=None) -> int:
        parser = argparse.ArgumentParser(
            prog=self.name, description=self.description)
        parser.add_argument("-v", "--version", action="version",
                            version=f"{self.name} (digiham_tpu_torch)")
        self.add_arguments(parser)
        args = parser.parse_args(argv)
        self.setup(args)

        stdin = sys.stdin.buffer
        stdout = sys.stdout.buffer
        itemsize = np.dtype(self.in_dtype).itemsize
        carry = b""
        while True:
            chunk = stdin.read(BUF_SIZE)
            if not chunk:
                break
            carry += chunk
            usable = len(carry) - len(carry) % itemsize
            if not usable:
                continue
            data = np.frombuffer(carry[:usable], dtype=self.in_dtype)
            carry = carry[usable:]
            out = self.process(data)
            if out:
                stdout.write(out)
                stdout.flush()
        out = self.flush()
        if out:
            stdout.write(out)
            stdout.flush()
        return 0


class DecoderCli(Cli):
    """Decoder tool: wires a runtime.Decoder + optional metadata fifo
    (src/lib/cli.cpp:117-141)."""

    def make_decoder(self):
        raise NotImplementedError

    def add_arguments(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument("-f", "--fifo", metavar="PATH",
                            help="send metadata to this file")

    def setup(self, args) -> None:
        self.decoder = self.make_decoder()
        if args.fifo:
            self.decoder.set_meta_writer(FileMetaWriter(args.fifo))

    def process(self, data: np.ndarray) -> bytes:
        return self.decoder.process(data)


def run_tool(tool_cls) -> int:
    return tool_cls().main()
