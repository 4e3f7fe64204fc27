"""Hand-written kernels for Hopper and the ops around them.

``demod_front`` holds kernels K1, K2 and K3 (the century demodulator
behind its three fronts), ``fir`` kernel K4 (the standalone many-channel
FIR), ``viterbi`` kernel K5, ``recurrence`` kernel K6 (the audio path's
serial recurrences: the digital-voice IIR and the DC blocker); ``build``
compiles and loads their CUDA sources; ``correlate`` is the sync correlation, plain
integer tensor work.
"""
