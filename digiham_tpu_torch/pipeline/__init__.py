"""Batched device pipelines."""
from .bank import PipelineState  # noqa: F401
from .dmr import (DmrPipeline, DmrPipelineState, DmrTables,  # noqa: F401
                  dmr_decode_frames, dmr_sync_correlate)
from .fsk import (FskPipeline, FskPipelineState, FskTables,  # noqa: F401
                  bit_sync_correlate, dstar_decode_frames,
                  pocsag_decode_frames)
from .nxdn import (NxdnPipeline, NxdnPipelineState, NxdnTables,  # noqa: F401
                   nxdn_decode_frames, nxdn_sync_correlate)
from .ysf import (YsfPipeline, YsfPipelineState, YsfTables,  # noqa: F401
                  ysf_decode_frames, ysf_sync_correlate)
