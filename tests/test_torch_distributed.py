"""Two-process ``torch.distributed`` validation of the port's scale-out
(the counterpart of tests/test_distributed.py): two spawned processes join
one gloo job on localhost with 4 CPU slots each, build the global
(channel, time) meshes, feed their own channel rows, and run the sharded
DMR step and one streaming step whose halo hops, carry ring and sum over
``time`` cross the processes (tests/torch_distributed_worker.py checks each
against the one-process mesh). Here the shards they computed are held
against the JAX package's sharded step on the 8-device virtual mesh, on
audio screened knife-edge free for every time shard."""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digiham_tpu.parallel import sharded_pipeline_step as j_pipeline_step
from torch_scale import bulk_windows, jax_mesh, screened_audio

_WORKER = os.path.join(os.path.dirname(__file__),
                       "torch_distributed_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two workers' outputs: (samples, [stdout], [saved shards])."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    tmp = tmp_path_factory.mktemp("dist")
    seg = 2 * (100 * 10 + 1) + 1  # two centuries a time shard
    total = 8 * seg
    x = screened_audio("dmr", 4, total, 900,
                       bulk_windows((2, 8), seg, 200, total))
    np.save(tmp / "x.npy", x)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(rank), str(port), str(tmp / "x.npy"),
         str(tmp / f"rank{rank}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out}"
    shards = [dict(np.load(tmp / f"rank{rank}.npz")) for rank in range(2)]
    return x, outs, shards


def test_two_process_steps_cross_processes(run):
    """Both workers finished every check: the (4, 2) mesh with rows per
    process, the (1, 8) mesh whose row and carry ring span both."""
    _, outs, _ = run
    for rank, out in enumerate(outs):
        assert f"DIST-OK rank {rank}" in out, out


def test_two_process_shards_match_jax(run):
    """The shards each process computed on the global (4, 2) mesh equal
    the JAX package's sharded DMR step on the virtual (4, 2) mesh."""
    x, _, shards = run
    voice, hits = j_pipeline_step(jax_mesh((4, 2)), jnp.asarray(x), 10, 2)
    voice, hits = np.asarray(voice), np.asarray(hits)
    assert voice.shape == (4, 2, 27)
    seen = 0
    for rank, saved in enumerate(shards):
        for key, data in saved.items():
            kind, *at = key.split("_")
            row = int(at[0])
            rows = slice(row, row + data.shape[0])
            if kind == "voice":
                col = int(at[1])
                want = voice[rows, col:col + data.shape[1]]
            else:
                want = hits[rows]
            np.testing.assert_array_equal(data.astype(np.int64),
                                          want.astype(np.int64), err_msg=key)
            assert row // 2 == rank  # host-major: each process's own rows
            seen += 1
    # per process: 2 channel shards x 2 time shards of voice, 2 of hits
    assert seen == 2 * (2 * 2 + 2)


def test_init_distributed_needs_a_card_for_none():
    """device=None asks for NCCL on the card: without one it raises and
    does not fall back to gloo."""
    from digiham_tpu_torch.parallel.distributed import init_distributed

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed(f"localhost:{_free_port()}", 1, 0)
