"""The benchmark of ``digiham_tpu_torch``: ``run.py`` runs one cell of
``BENCHMARK.json`` once; ``control.py`` runs the control of its
comparison. Everything a cell needs is found by name under this folder:
``configs/``, ``traffic/``, ``metrics/``, the TX copies in ``synth/`` and
the plain reference in ``reference/``."""
