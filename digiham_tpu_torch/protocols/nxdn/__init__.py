"""NXDN protocol data (constants only; the phase machines are not ported)."""
from . import constants  # noqa: F401
