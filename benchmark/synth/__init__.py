"""The TX side of the traffic, one module a protocol (named as the
configurations' ``protocol``): frozen numpy copies of
``digiham_tpu_torch``'s frame builders (``bench/dmr_synth.py``,
``soak/synth.py``) over the reference's encoders, so that a change to the
program cannot move the yardstick. Each module gives ``SYMBOL_RATE`` and
``call(rng, seconds, variant)``: one transmission's dibits, of the
protocol's kind ``variant`` (a YSF call's mode)."""
