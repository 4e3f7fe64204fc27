"""The port's on-card verification programs, one module per JAX program
they port:

- :mod:`.impairments` (tools/impairments.py): channel impairments of I/Q
  streams (CFO, multipath, clipping, clock skew, AWGN), also planar and
  over a bank of channels with one seed each;
- :mod:`.classify` (tools/soak_classify.py): machine classification of a
  decode miss against the knife-edge classes, on the port's own oracle;
- :mod:`.synth` (tests/ysf_synth.py, tests/nxdn_synth.py and the stream
  builders of tools/fuzz_timesharded.py): the TX side of the five
  protocols;
- :mod:`.dmr_soak` (tools/tpu_soak.py): a long noisy DMR voice stream
  through the streaming bank, every miss classified;
- :mod:`.impaired` (tests/test_impaired_rf.py): the impaired-RF matrix
  through the raw-I/Q path and the audio bank, held to the TX truth;
- :mod:`.ser_equiv` (tools/tpu_ser_equiv.py): symbol error rates of the
  three demod routes on the same noisy symbols, and their cross-path
  mismatch;
- :mod:`.ber_sweep` (tools/ber_sweep.py): DMR symbol error rate and voice
  frame success against SNR over the full chain;
- :mod:`.fuzz_timesharded` (tools/fuzz_timesharded.py): random streams of
  the five protocols through the time-sharded bank and the unsharded one.

``python3 -m digiham_tpu_torch.soak [program ...]`` runs them on the card
(:mod:`.__main__`); each takes ``device="cpu"`` for the plain versions.
"""
