"""The comparison that decides ``correct`` catches a broken timed path:
the harness runs on the CPU at small sizes with each fault a cell can
have planted under it (the look for a card skipped), and a sound run
passes. The cells' own limits are used, so each fault has to fail them
at this size too."""

import pytest

from dtxbench.harness import faults
from dtxbench.tests import small

TRAIN = ["train.qwen1.5-7b.lora", "train.qwen1.5-14b.qlora-nf4"]
SERVE = ["serve.qwen1.5-7b.chat-saturated"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_sound_run_is_correct(cell):
    res = small.run(cell)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_training_fault_is_caught(cell, fault):
    res = small.run(cell, fault=faults.TRAIN[fault])
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_serving_fault_is_caught(cell, fault):
    res = small.run(cell, fault=faults.SERVE[fault])
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("cell", TRAIN)
def test_wrong_dropout_keys_are_caught(cell, monkeypatch):
    """A step whose LoRA dropout draws from another key than the job's."""
    from datatunerx_tpu_torch.training import train_lib

    monkeypatch.setattr(train_lib, "prng", _ShiftedKeys(train_lib.prng))
    res = small.run(cell)
    assert not res["correct"], res["compared"]


class _ShiftedKeys:
    def __init__(self, prng):
        self._p = prng

    def __getattr__(self, name):
        return getattr(self._p, name)

    def fold_in(self, key, data):
        if data == 0x57E9:
            data += 1
        return self._p.fold_in(key, data)


def test_traced_runs_read_their_metrics():
    for cell in (TRAIN[0], SERVE[0]):
        res = small.run(cell, trace=True, seconds=2.0)
        assert res["correct"]
        assert res["device"]["window_s"] > 0
        assert {"device_ops", "idle_gaps"} <= set(res["breakdown"])
        assert res["metrics"]
