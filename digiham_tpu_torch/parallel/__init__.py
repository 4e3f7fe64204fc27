"""Scale-out over several devices and processes: the (channel, time) mesh
and its bulk steps (``sharded``), the exact streaming carry ring
(``streaming``), and ``torch.distributed`` bring-up (``distributed``)."""
from .sharded import (  # noqa: F401
    LocalRows,
    Mesh,
    Shard,
    Slot,
    make_mesh,
    sharded_fsk_step,
    sharded_gfsk_step,
    sharded_pipeline_step,
    sharded_rrc_filter,
)
from .streaming import (  # noqa: F401
    TimeShardedDmrPipeline,
    TimeShardedDmrStream,
    TimeShardedPipeline,
    TimeShardedStream,
)
