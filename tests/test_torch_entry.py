"""The port's entry module (``digiham_tpu_torch/entry.py``): ``entry("cpu")``
against ``__graft_entry__.entry()`` (the JAX package's step) on the same
samples, every output field and the demod state; and
``dryrun_multichip(n, "cpu")``, every scale-out path over a mesh naming the
CPU n times. Integers exact; float state within 1e-3 (float32 sums in
another order)."""
import numpy as np
import pytest
import torch

import __graft_entry__ as j_entry
from digiham_tpu_torch import entry

torch.set_num_threads(1)


def test_entry_equals_the_jax_entry():
    fn, (samples, state) = entry.entry("cpu")
    j_fn, (j_samples, j_state) = j_entry.entry()
    np.testing.assert_array_equal(samples.numpy(), np.asarray(j_samples))
    out, new_state = fn(samples, state)
    j_out, j_new_state = j_fn(j_samples, j_state)
    assert set(out) == set(j_out)
    for key, want in j_out.items():
        got, want = out[key].numpy(), np.asarray(want)
        assert got.shape == want.shape, key
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, atol=1e-3, err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    assert out["dibits"].shape == (8, 200)
    for name in ("pos", "offset"):
        np.testing.assert_array_equal(
            getattr(new_state.demod, name).numpy(),
            np.asarray(getattr(j_new_state.demod, name)))


def test_entry_runs_on_the_named_device_only():
    fn, (samples, state) = entry.entry("cpu")
    assert samples.device.type == "cpu"
    assert fn(samples, state)[0]["dibits"].device.type == "cpu"


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_on_the_cpu(n):
    entry.dryrun_multichip(n, "cpu")


def test_mesh_devices():
    assert entry.mesh_devices(3, "cpu") == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.mesh_devices(2)
