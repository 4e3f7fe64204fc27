"""digiham_tpu_torch — the PyTorch/CUDA port of digiham_tpu.

The same many-channel digital-voice decoding, written for one NVIDIA
Hopper GPU: plain PyTorch around hand-written CUDA kernels that replace
the JAX package's Pallas kernels. The layout and names mirror
``digiham_tpu`` so each module's counterpart is easy to find. The package
imports ``torch`` and never ``jax`` or ``digiham_tpu``: protocol tables
and filter designs are carried here as data, and tests prove them equal
to the JAX package's.
"""

__version__ = "0.1.0"

_SUBMODULES = ("fec", "dsp", "protocols", "pipeline", "ops", "runtime",
               "parallel", "codec", "cli", "convert", "smoke", "utils")


def resolve_device(device=None):
    """The device an entry point works on. ``None`` means the card: it
    returns ``torch.device("cuda")`` and raises when no CUDA device is
    present, never giving way to the CPU. Anything else is taken as the
    caller's explicit choice (the CPU tests pass ``"cpu"``)."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "digiham_tpu_torch found no CUDA device: its entry points run "
            "on an NVIDIA GPU unless the caller asks for another device "
            "(pass device=\"cpu\" for the plain PyTorch versions)")
    return torch.device("cuda")


def __getattr__(name):
    """Lazy subpackage access: ``import digiham_tpu_torch`` stays cheap
    (no torch import) while ``digiham_tpu_torch.dsp`` etc. resolve on
    first touch."""
    if name in _SUBMODULES:
        import importlib

        module = importlib.import_module(f".{name}", __name__)
        globals()[name] = module
        return module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
