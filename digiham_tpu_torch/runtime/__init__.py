"""The host side of the bank paths: sample buffering and block dispatch
(``stream``), the banks (``channel_bank``, ``tracked_bank``), the decoder
loop and metadata transport (``decoder``, ``meta``), checkpoints,
the banks' spans and counters and the host machines' diagnostic lines
(``checkpoint``, ``metrics``, ``diag``)."""
from .meta import (FileMetaWriter, MetaCollector, MetaWriter,  # noqa: F401
                   PipelineMetaWriter, StringSerializer)
from .stream import SampleBuffer, StreamDriver  # noqa: F401
