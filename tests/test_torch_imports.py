"""The port must import on a machine without JAX: a fresh interpreter
imports ``digiham_tpu_torch`` and every submodule with ``jax`` and
``digiham_tpu`` blocked by a ``sys.meta_path`` finder, and the kernel
modules import without ``nvcc`` or a GPU (they build at first launch). The
host library of ``native`` (which the control plane's Viterbi runs) is
built with the host compiler first, with JAX blocked; then the PATH is
emptied."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, os, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "digiham_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    # the host library: g++ (and the assembler it runs) from the PATH
    from digiham_tpu_torch import native
    native.load()
    # no CUDA toolkit and no card: the kernel module must not need them
    os.environ["PATH"] = ""
    os.environ["CUDA_HOME"] = "/nonexistent"
    os.environ["CUDA_VISIBLE_DEVICES"] = ""

    import digiham_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        digiham_tpu_torch.__path__, "digiham_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    from digiham_tpu_torch.ops import (build, demod_front, fir, recurrence,
                                       viterbi)
    assert not build._LIBS  # nothing was built or loaded
    assert not any(demod_front.LAUNCHES.values()) and viterbi.LAUNCHES == 0
    assert fir.LAUNCHES == 0 and not any(recurrence.LAUNCHES.values())
    for sub in ("fec.crc", "fec.lfsr", "fec.viterbi", "ops.build",
                "ops.viterbi", "pipeline.bank", "pipeline.ysf",
                "pipeline.nxdn", "protocols.ysf.constants",
                "protocols.nxdn.constants", "ops.fir", "utils",
                "fec.rs129", "runtime.meta", "runtime.decoder",
                "runtime.metrics", "runtime.checkpoint", "runtime.stream",
                "runtime.channel_bank", "runtime.tracked_bank",
                "protocols.dmr.components", "protocols.dmr.phases",
                "protocols.dmr.meta", "protocols.dmr.decoder",
                "protocols.dmr.fields_phase", "protocols.ysf.primitives",
                "protocols.ysf.fich", "protocols.ysf.data",
                "protocols.ysf.meta", "protocols.ysf.phases",
                "protocols.ysf.fields_phase", "protocols.ysf.decoder",
                "protocols.nxdn.components", "protocols.nxdn.meta",
                "protocols.nxdn.phases", "protocols.nxdn.fields_phase",
                "protocols.nxdn.decoder", "pipeline.fsk",
                "protocols.dstar.phases", "protocols.dstar.header",
                "protocols.dstar.meta", "protocols.dstar.decoder",
                "protocols.dstar.fields_phase", "protocols.pocsag",
                "dsp.audio", "ops.recurrence", "codec.modes", "codec.proto",
                "codec.mbe", "cli.base", "cli.tools", "parallel",
                "parallel.sharded", "parallel.streaming",
                "parallel.distributed", "runtime.multistream", "native",
                "fec.syndrome_tool", "entry", "bench", "bench.common",
                "bench.headline", "bench.bench_protocols",
                "bench.bench_multistream", "bench.bench_latency",
                "bench.dmr_synth", "bench.host_synth",
                "bench.host_tracking", "bench.stages", "bench.kernels",
                "ops.variants", "soak", "soak.__main__",
                "soak.impairments", "soak.classify", "soak.synth",
                "soak.dmr_soak", "soak.impaired", "soak.ser_equiv",
                "soak.ber_sweep", "soak.fuzz_timesharded"):
        assert "digiham_tpu_torch." + sub in names, sub
    # the host control plane runs with both names blocked: each protocol's
    # decoder, and a tracked bank's symbol-domain entry, on noise dibits
    import numpy as np
    from digiham_tpu_torch.pipeline import (FskPipeline, NxdnPipeline,
                                            YsfPipeline)
    from digiham_tpu_torch.protocols import dmr, dstar, nxdn, pocsag, ysf
    from digiham_tpu_torch.runtime.tracked_bank import (
        DstarAdapter, NxdnAdapter, PocsagAdapter, TrackedChannelBank,
        YsfAdapter)
    rng = np.random.default_rng(1)
    noise = rng.integers(0, 4, 3000).astype(np.uint8)
    bits = rng.integers(0, 2, 6000).astype(np.uint8)
    for proto in (dmr, ysf, nxdn):
        proto.make_decoder().process(noise)
    for proto in (dstar, pocsag):
        proto.make_decoder().process(bits)
    # ... and its snapshot pickles and restores the YSF, NXDN, D-Star and
    # POCSAG machines
    for pipe, adapter, symbols in (
            (YsfPipeline(2, device="cpu"), YsfAdapter(), noise),
            (NxdnPipeline(2, device="cpu"), NxdnAdapter(), noise),
            (FskPipeline(2, "dstar", device="cpu"), DstarAdapter(), bits),
            (FskPipeline(2, "pocsag", device="cpu"), PocsagAdapter(),
             bits)):
        bank = TrackedChannelBank(pipe, adapter=adapter, device="cpu")
        bank.push_dibits(np.stack([symbols, symbols]))
        TrackedChannelBank(pipe, adapter=adapter, device="cpu").restore(
            bank.snapshot())
    # the command line's host paths run with both names blocked too: the
    # numpy post-filter and the codec's wire format
    from digiham_tpu_torch.codec import proto
    from digiham_tpu_torch.dsp.audio import DigitalVoiceFilterNp
    DigitalVoiceFilterNp().process(np.arange(100, dtype=np.int16))
    proto.unpack_any(proto.pack_any(proto.Check("ambe")))
    for sub in digiham_tpu_torch._SUBMODULES:
        assert getattr(digiham_tpu_torch, sub).__name__.endswith(sub)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "digiham_tpu"))
    assert not bad, bad
    print("OK", len(names))
""")


SCALE_OUT = textwrap.dedent("""
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "digiham_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import digiham_tpu_torch.parallel as parallel
    from digiham_tpu_torch.parallel import distributed, streaming
    from digiham_tpu_torch.runtime import multistream
    for name in ("make_mesh", "sharded_rrc_filter", "sharded_pipeline_step",
                 "sharded_gfsk_step", "sharded_fsk_step",
                 "TimeShardedPipeline", "TimeShardedStream",
                 "TimeShardedDmrPipeline", "TimeShardedDmrStream"):
        assert hasattr(parallel, name), name
    assert callable(distributed.init_distributed)
    assert multistream.MultiStreamBank and multistream.WorkerDied
    # a (2, 2) mesh of CPU slots steps a stream with both names blocked
    mesh = parallel.make_mesh(2, 2, devices=["cpu"] * 4)
    sp = streaming.TimeShardedPipeline(mesh, 2, "dstar",
                                       centuries_per_shard=1)
    x = np.random.default_rng(0).normal(0, 500, (2, 3 * sp.block_len))
    outs = streaming.TimeShardedStream(sp).push(x.astype(np.float32))
    assert len(outs) == 2 and outs[0]["dibits"].shape == (2, 200)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "digiham_tpu"))
    assert not bad, bad
    print("OK")
""")


def test_scale_out_imports_and_steps_without_jax():
    """``digiham_tpu_torch.parallel`` and ``runtime.multistream`` import,
    and a time-sharded stream steps on a CPU mesh, with ``jax`` and the
    JAX package blocked."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCALE_OUT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "OK"


def test_port_imports_without_jax_or_cuda():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[-1])
    assert n >= 60, proc.stdout  # every module of the package was walked
