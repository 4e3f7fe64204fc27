"""Batched device pipelines."""
from .dmr import (DmrPipeline, DmrPipelineState, DmrTables,  # noqa: F401
                  dmr_decode_frames, dmr_sync_correlate)
