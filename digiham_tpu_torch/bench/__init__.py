"""The port's measuring programs, one module per JAX program they port:

- ``python3 -m digiham_tpu_torch.bench`` (:mod:`.headline`, bench.py): raw-IQ
  DMR throughput on one card, with the multi-process stage;
- :mod:`.bench_protocols` (tools/bench_protocols.py): one throughput line
  per protocol at the long blocks;
- :mod:`.bench_multistream` (tools/bench_multistream.py): the aggregate of N
  processes on one card;
- :mod:`.bench_latency` (tools/bench_latency.py): ingest to voice-frame-out
  latency per frame, in ms of air;

Each runs on the card unless called with ``--device cpu``, gates its
numbers on a committed fixture, and prints JSON lines (:mod:`.common`).
"""
