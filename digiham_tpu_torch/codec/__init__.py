"""The codecserver bridge (port of ``digiham_tpu/codec``): AMBE codec
modes, the protobuf wire codec of codecserver's framed-Any dialect, and
``MbeSynthesizer``, which ships channel frames to a codecserver and
receives s16 PCM. Host Python over sockets; the port keeps its own copy
and imports nothing of the JAX package."""
from .modes import Mode, TableMode, ControlWordMode, DynamicMode  # noqa: F401
from .mbe import (MbeSynthesizer, ConnectionError_, ProtocolError,  # noqa: F401
                  VersionError)
