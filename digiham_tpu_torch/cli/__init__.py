"""The ten pipe tools of the port (``cli/tools.py``; entry points
``<tool>_torch`` in ``pyproject.toml``): the JAX package's tools with the
DSP on the card by default (``--backend cuda``), the same code on the CPU
(``--backend cpu``) or the host oracles (``--backend numpy``)."""
