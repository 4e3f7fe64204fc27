"""The host FEC of the reference decoders, and the encoders of the
traffic: block codes, BPTC(196,96), RS(12,9), CRCs, keystreams,
interleaves and the rate-1/2 trellis, in numpy."""
