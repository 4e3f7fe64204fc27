"""Hand-written kernels for Hopper and the ops around them.

``demod_front`` holds kernel K1 (the fused raw-IQ front); ``correlate`` is
the sync correlation, plain integer tensor work.
"""
