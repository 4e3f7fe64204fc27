"""The benchmark's plain reference of a receive bank: the front, an RRC
or none and the 4FSK or 2FSK century demodulator, in plain PyTorch
(:mod:`.dsp`, the filter chosen by the configuration's ``rrc``), then
one symbol-domain decoder a channel, digiham's phase machines with host
FEC (:mod:`.dmr`, :mod:`.ysf`, over :mod:`.fec`), run by :mod:`.stream`.
A protocol is a subpackage named as the configuration's ``protocol``:
its ``make_decoder()`` gives a fresh decoder of one channel's symbols,
and its ``DEMOD`` (default ``"gfsk"``) and ``INVERT`` (default false)
give the front's slicer.

Frozen copies of ``digiham_tpu_torch``'s plain versions and host machines,
which are held to digiham's C++ decoders; this package imports nothing of
the program, so a change to the program cannot move the yardstick."""
