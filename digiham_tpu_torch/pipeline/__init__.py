"""Batched device pipelines, and each protocol's record (:class:`Protocol`):
``PROTOCOLS`` maps a protocol's name to it."""
from .bank import PipelineState, Protocol, Sync  # noqa: F401
from .dmr import (DMR, DmrPipeline, DmrPipelineState,  # noqa: F401
                  DmrTables, dmr_decode_frames, dmr_sync_correlate)
from .fsk import (DSTAR, POCSAG, FskPipeline,  # noqa: F401
                  FskPipelineState, FskTables, bit_sync_correlate,
                  dstar_decode_frames, pocsag_decode_frames)
from .nxdn import (NXDN, NxdnPipeline, NxdnPipelineState,  # noqa: F401
                   NxdnTables, nxdn_decode_frames, nxdn_sync_correlate)
from .ysf import (YSF, YsfPipeline, YsfPipelineState,  # noqa: F401
                  YsfTables, ysf_decode_frames, ysf_sync_correlate)

PROTOCOLS = {p.name: p for p in (DMR, YSF, NXDN, DSTAR, POCSAG)}


def protocol_named(name: str) -> Protocol:
    """The record of the protocol called ``name``; a ValueError names the
    known ones."""
    if name not in PROTOCOLS:
        raise ValueError(f"unknown protocol {name!r} (one of "
                         f"{', '.join(PROTOCOLS)})")
    return PROTOCOLS[name]
