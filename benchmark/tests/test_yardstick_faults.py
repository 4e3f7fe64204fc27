"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped (the program's plain versions
on the CPU) and the rest of a run is driven, once for each fault a cell
can have. The exchange between chips is not among them: every cell is
on one chip."""
import pytest
import torch

from conftest import run_small, small_cell

pytest.importorskip("digiham_tpu_torch")


def _state_unchanged(monkeypatch):
    """The step hands back the demod's carried slew and AGC ring as it
    got them (its position moves on, so the stream still advances)."""
    from digiham_tpu_torch.pipeline.bank import BankPipeline

    step = BankPipeline.step_symbols

    def stale(self, samples, state):
        out, new = step(self, samples, state)
        new.demod.offset = state.demod.offset
        new.demod.volume_ring = state.demod.volume_ring
        return out, new

    monkeypatch.setattr(BankPipeline, "step_symbols", stale)


def _half_the_batch(monkeypatch):
    """The step leaves out the second half of the channels: their
    symbols stay zero."""
    from digiham_tpu_torch.pipeline.bank import BankPipeline

    step = BankPipeline.step_symbols

    def half(self, samples, state):
        out, new = step(self, samples, state)
        dibits = out["dibits"].clone()
        dibits[dibits.shape[0] // 2:] = 0
        return ({"dibits": dibits, "sync_dist_dense": self.sync_dense(dibits)},
                new)

    monkeypatch.setattr(BankPipeline, "step_symbols", half)


def _answer_altered(monkeypatch):
    """The frame decode alters a bit of every voice field it produces."""
    from digiham_tpu_torch.runtime import tracked_bank

    for cls, field in ((tracked_bank.DmrAdapter, "voice_payload"),
                       (tracked_bank.YsfAdapter, "vd2_voice")):
        decode = cls.decode_fields

        def altered(self, frames, pipeline, decode=decode, field=field):
            host = decode(self, frames, pipeline)
            host[field] = host[field] ^ 1
            return host

        monkeypatch.setattr(cls, "decode_fields", altered)


def _last_step_held_back(monkeypatch):
    """The bank hands each step's symbols to its host side one step late,
    and so never hands over the last step's: what it hands over is a
    true start of the stream, and every frame due before the drain still
    comes out."""
    import numpy as np

    from digiham_tpu_torch.runtime.tracked_bank import TrackedChannelBank

    step = TrackedChannelBank._step

    def late(self, block):
        hits, symbols = step(self, block)
        held = getattr(self, "_held", None)
        self._held = (hits, symbols)
        if held is None:
            return np.zeros_like(hits), symbols[:, :0]
        return held

    monkeypatch.setattr(TrackedChannelBank, "_step", late)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch,
                                   _answer_altered, _last_step_held_back])
@pytest.mark.parametrize("name", ["dmr_site.busy", "ysf_site.live"])
def test_broken_path_is_not_correct(monkeypatch, fault, name):
    fault(monkeypatch)
    # short gaps: at this size every channel has calls in the run
    result, _ = run_small(small_cell(name, gap_seconds=[0.2, 0.6]))
    assert result["correct"] is False, result["checks"]
    assert result["failed"] > 0 or any(
        v["value"] > v["limit"] for v in result["checks"].values())
    if fault is _last_step_held_back:
        # only the count of the steps' symbols sees it
        assert result["checks"]["symbols_wrong"]["value"] > 0


def test_unbroken_path_is_correct():
    result, _ = run_small(small_cell("dmr_site.busy"))
    assert result["correct"] is True
    assert torch.device("cpu").type == "cpu"
