"""One channel's dibits through its protocol's symbol-domain decoder, with
where each output falls in the stream.

The loop is the decoder's own (``decoder.Decoder.process``: run the phase
while more than its lookahead is buffered) over the whole stream at once,
noting after each call of a phase what it wrote: a voice frame's bytes or
a metadata event, and the stream position of the last symbol it had
consumed. A voice frame is what one call of a frame phase writes.

    python3 -m benchmark.reference.stream < tasks > results

decodes a pickled list of (protocol, dibits) from standard input and
writes the pickled list of results to standard output: one worker process
of the benchmark's comparison."""
from __future__ import annotations

import importlib
import pickle
import sys

import numpy as np

from .meta import PipelineMetaWriter


def decode_channel(protocol: str, dibits: np.ndarray):
    """(frames, events) of one channel: ``frames`` a list of (end symbol,
    bytes), ``events`` a list of (end symbol, serialized event); the end
    symbol is one past the last symbol the phase had consumed when it
    wrote."""
    dec = importlib.import_module(f"{__package__}.{protocol}").make_decoder()
    events, pending = [], []
    dec.set_meta_writer(PipelineMetaWriter(pending.append))
    frames = []
    buf = np.asarray(dibits, np.uint8)
    pos, n = 0, len(buf)
    while n - pos > dec.current_phase.required_data():
        next_phase, consumed = dec.current_phase.process(buf[pos:],
                                                         dec.output)
        pos += consumed
        out = dec.output.drain()
        if out:
            frames.append((pos, out))
        if pending:
            events += [(pos, e) for e in pending]
            pending.clear()
        if next_phase is not None:
            dec.set_phase(next_phase)
    return frames, events


def decode_many(args):
    """:func:`decode_channel` over a list of (protocol, dibits), for a
    worker process."""
    return [decode_channel(p, d) for p, d in args]


if __name__ == "__main__":
    pickle.dump(decode_many(pickle.load(sys.stdin.buffer)), sys.stdout.buffer,
                protocol=pickle.HIGHEST_PROTOCOL)
