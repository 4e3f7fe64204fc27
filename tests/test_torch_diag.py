"""``runtime/diag.py``: a diagnostic line goes to standard error at once,
or, inside a batch, with the batch's other lines in one write at its
end."""
import sys

import pytest

from digiham_tpu_torch.runtime import diag


class _Stderr:
    """Keeps each write to standard error."""

    def __init__(self):
        self.writes = []

    def write(self, text):
        self.writes.append(text)
        return len(text)

    def flush(self):
        pass


def _stderr(monkeypatch) -> _Stderr:
    """Standard error replaced for the test's body (pytest puts its own
    back between a fixture's set-up and the test)."""
    out = _Stderr()
    monkeypatch.setattr(sys, "stderr", out)
    return out


def test_say_writes_at_once_outside_a_batch(monkeypatch):
    err = _stderr(monkeypatch)
    diag.say("FACCH1 message type: 1")
    assert "".join(err.writes) == "FACCH1 message type: 1\n"


def test_a_batch_writes_its_lines_once_in_order_at_its_end(monkeypatch):
    err = _stderr(monkeypatch)
    with diag.batch():
        diag.say("a")
        with diag.batch():
            diag.say("b")
        diag.say("c")
        assert err.writes == []
    assert err.writes == ["a\nb\nc\n"]
    with diag.batch():
        pass
    assert err.writes == ["a\nb\nc\n"]
    diag.say("d")
    assert "".join(err.writes[1:]) == "d\n"


def test_a_batch_that_raises_still_writes_its_lines(monkeypatch):
    err = _stderr(monkeypatch)
    with pytest.raises(RuntimeError):
        with diag.batch():
            diag.say("before")
            raise RuntimeError("tracker failed")
    assert err.writes == ["before\n"]
    diag.say("after")
    assert "".join(err.writes[1:]) == "after\n"
