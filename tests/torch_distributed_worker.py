"""Worker process for tests/test_torch_distributed.py (imports torch and
the port only).

Joins a 2-process ``torch.distributed`` gloo job on localhost (4 CPU slots
a process -> 8 global), then:

1. the global (4, 2) mesh, host-major (each channel row inside one
   process), this process's rows through ``make_global_array``, one
   ``sharded_pipeline_step``: its shards equal the same step on a
   one-process (4, 2) mesh and are saved for the parent to hold against
   the JAX package;
2. the global (1, 8) mesh, whose one channel row spans both processes:
   the halo hops cross them through ``batch_isend_irecv`` and the sync
   hits sum through ``all_reduce`` on the row's group; the step's shards
   equal the one-process (1, 8) mesh's;
3. on the same (1, 8) mesh one ``TimeShardedPipeline.step`` (NXDN, one
   century a shard): the carry ring hops between the processes; outputs
   and the new state (on the process of time shard 0) equal the
   one-process step's.

Usage: python torch_distributed_worker.py <rank> <port> <samples.npy> <out>
"""
import sys

import numpy as np
import torch

RANK, PORT, SAMPLES, OUT = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                            sys.argv[4])

from digiham_tpu_torch.parallel import (make_mesh,  # noqa: E402
                                        sharded_pipeline_step)
from digiham_tpu_torch.parallel.distributed import (  # noqa: E402
    global_channel_mesh, init_distributed, local_channel_slice,
    make_global_array)
from digiham_tpu_torch.parallel.streaming import (  # noqa: E402
    TimeShardedPipeline)

torch.set_num_threads(1)
init_distributed(f"localhost:{PORT}", 2, RANK, device="cpu")
import torch.distributed as dist  # noqa: E402

assert dist.get_backend() == "gloo" and dist.get_world_size() == 2

x = np.load(SAMPLES)
C = x.shape[0]
N_CENT, SPS = 2, 10


def check_shards(shards, want, what):
    assert shards, what
    for s in shards:
        np.testing.assert_array_equal(s.data.numpy(), want[s.index].numpy(),
                                      err_msg=f"{what} {s.index}")


# 1. channel rows inside each process
mesh = global_channel_mesh(n_time_shards=2, devices=["cpu"] * 4)
assert mesh.shape == {"channel": 4, "time": 2}, mesh.shape
assert not mesh.single_process and not mesh.row_groups
rows = local_channel_slice(C)
assert rows == slice(RANK * 2, (RANK + 1) * 2), rows
local = make_global_array(x[rows], mesh)
assert local.shape == x.shape and local.rows == rows
voice, hits = sharded_pipeline_step(mesh, local, SPS, N_CENT)
want_voice, want_hits = sharded_pipeline_step(
    make_mesh(4, 2, devices=["cpu"] * 8), x, SPS, N_CENT)
check_shards(voice, want_voice, "voice (4, 2)")
check_shards(hits, want_hits, "hits (4, 2)")
out = {}
for s in voice:
    out[f"voice_{s.index[0].start}_{s.index[1].start}"] = s.data.numpy()
for s in hits:
    out[f"hits_{s.index[0].start}"] = s.data.numpy()

# 2. one channel row across both processes
mesh8 = global_channel_mesh(n_time_shards=8, devices=["cpu"] * 4)
assert mesh8.shape == {"channel": 1, "time": 8}, mesh8.shape
assert list(mesh8.row_groups) == [0]
voice8, hits8 = sharded_pipeline_step(mesh8, x, SPS, N_CENT)
want_voice8, want_hits8 = sharded_pipeline_step(
    make_mesh(1, 8, devices=["cpu"] * 8), x, SPS, N_CENT)
assert len(voice8) == 4
check_shards(voice8, want_voice8, "voice (1, 8)")
check_shards(hits8, want_hits8, "hits (1, 8)")

# 3. the streaming carry ring across both processes
sp = TimeShardedPipeline(mesh8, C, "nxdn", centuries_per_shard=1)
one = TimeShardedPipeline(make_mesh(1, 8, devices=["cpu"] * 8), C, "nxdn",
                          centuries_per_shard=1)
need = sp.h_left + sp.block_len + sp.h_right
audio = np.ascontiguousarray(np.tile(x, (1, need // x.shape[1] + 1))[
    :, :need]) * 0.5
body = audio[:, sp.h_left:sp.h_left + sp.block_len]
edges = np.concatenate([audio[:, :sp.h_left],
                        audio[:, sp.h_left + sp.block_len:]], axis=1)
outs, state = sp.step(body, edges, sp.init_state())
want_outs, want_state = one.step(body, edges, one.init_state())
for key, shards in outs.items():
    check_shards(shards, want_outs[key], f"streaming {key}")
if RANK == 0:
    for got, want in zip((state.data.pos, state.data.offset,
                          state.data.volume_ring),
                         (want_state.pos, want_state.offset,
                          want_state.volume_ring)):
        assert torch.equal(got, want)
    assert state.rows == slice(0, C)
else:
    assert state is None
np.savez(OUT, **out)
dist.destroy_process_group()
print(f"DIST-OK rank {RANK}", flush=True)
