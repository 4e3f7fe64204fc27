"""Module-level ``worker_init`` functions for the port's MultiStreamBank
tests (a worker unpickles them by module path, so they live outside the
test files, which import JAX)."""
import sys

FORBIDDEN = ("jax", "jaxlib", "digiham_tpu")


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"a worker imported {name}")
        return None


def forbid_jax(bank):
    """Fail the worker if it has imported ``jax`` or the JAX package, and
    make any later import of either raise inside it."""
    bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if bad:
        raise RuntimeError(f"the worker imported {bad}")
    sys.meta_path.insert(0, _Block())


def fail(bank):
    """A worker_init that fails, as a kernel that does not build would."""
    raise RuntimeError(f"worker of channel {bank.first_channel} refuses")


def forbid_jax_and_record(directory, bank):
    """:func:`forbid_jax`, then ``smoke.record_worker`` (events to files
    under global channel ids, launch counts after the flush)."""
    from digiham_tpu_torch import smoke

    forbid_jax(bank)
    smoke.record_worker(directory, bank)
