"""The benchmark's plain reference of a receive bank: the RRC and the
4FSK century demodulator in plain PyTorch (:mod:`.dsp`), then one
symbol-domain decoder a channel, digiham's phase machines with host FEC
(:mod:`.dmr`, :mod:`.ysf`, over :mod:`.fec`), run by :mod:`.stream`.

Frozen copies of ``digiham_tpu_torch``'s plain versions and host machines,
which are held to digiham's C++ decoders; this package imports nothing of
the program, so a change to the program cannot move the yardstick."""
