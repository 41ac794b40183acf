"""The port's ``nan_rollback`` on the CPU, after ``tests/test_nan_rollback.py``.

``api.train(fault_hook=)`` poisons the live parameters with NaN after an
epoch's train pass, as a hardware blast would; the run rolls back to the
last checkpoint (or re-initialises before the first), records the event
and continues, within its budget. Every run is a tiny MNIST config (8
latents, 4 epochs of 3 steps), about a second.
"""

import json
import math
import os

import pytest
import torch

from mmvae_torch import api, configs
from mmvae_torch.train.checkpoint import latest_epoch
from torch_threads import _one_torch_thread  # noqa: F401


def _tiny(**kw):
    return configs.get_config("mnist").replace(
        n_latents=8, epochs=4, train_size=60, test_size=30, batch_size=20,
        annealing_epochs=2, **kw)


def _poison(state):
    with torch.no_grad():
        for p in state.model.parameters():
            p.mul_(float("nan"))
    return state


def _records(workdir, kind):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def _blast_once(at_epoch):
    blasted = []

    def hook(epoch, state):
        if epoch == at_epoch and not blasted:
            blasted.append(epoch)
            return _poison(state)
        return state

    return hook


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_transient_nan_rolls_back_and_recovers(tmp_path, accum_steps):
    """A blast after epoch 2's train pass: epoch 1's checkpoint is restored
    (with accumulation, its running mean too), the retry of epoch 2 and
    the rest run finite, one event is written, the blast never reaches the
    history or the checkpoints, and its eval is skipped."""
    wd = str(tmp_path)
    result = api.train(_tiny(nan_rollback=2, accum_steps=accum_steps), wd, device="cpu",
                       verbose=False, fault_hook=_blast_once(2))
    assert [r["epoch"] for r in result.history] == [1, 2, 3, 4]
    assert all(math.isfinite(r["test_elbo"]) for r in result.history)
    assert math.isfinite(result.best_test_elbo)
    (event,) = _records(wd, "event")
    assert {k: event[k] for k in ("event", "failed_epoch", "restored_epoch", "rollbacks")} == {
        "event": "nan_rollback", "failed_epoch": 2, "restored_epoch": 1, "rollbacks": 1}
    assert [r["epoch"] for r in _records(wd, "eval")] == [1, 2, 3, 4]
    assert [r["epoch"] for r in _records(wd, "train")] == [1, 2, 2, 3, 4]
    assert latest_epoch(wd) == 4
    assert result.state.step == 12
    assert all(torch.isfinite(p).all() for p in result.model.parameters())


def test_the_retry_draws_other_numbers_than_the_blast(tmp_path):
    """The order and noise generators are reseeded after a rollback: the
    retried epoch 2 trains on another order and noise than the first
    epoch 2, so its first train loss differs."""
    wd = str(tmp_path)
    api.train(_tiny(nan_rollback=1), wd, device="cpu", verbose=False,
              fault_hook=_blast_once(2))
    first, retry = [r["loss"] for r in _records(wd, "train") if r["epoch"] == 2]
    assert first != retry


def test_rollback_budget_exhausted_raises(tmp_path):
    """A fault at every epoch: one rollback is spent, the next raises."""
    wd = str(tmp_path)
    with pytest.raises(RuntimeError, match="nan_rollback budget"):
        api.train(_tiny(nan_rollback=1), wd, device="cpu", verbose=False,
                  fault_hook=lambda epoch, state: _poison(state))
    assert len(_records(wd, "event")) == 1


def test_first_epoch_blast_reinitializes(tmp_path):
    """A blast before the first checkpoint builds the model anew from a
    folded seed and starts again at epoch 1."""
    wd = str(tmp_path)
    result = api.train(_tiny(nan_rollback=1), wd, device="cpu", verbose=False,
                       fault_hook=_blast_once(1))
    assert [r["epoch"] for r in result.history] == [1, 2, 3, 4]
    (event,) = _records(wd, "event")
    assert event["failed_epoch"] == 1 and event["restored_epoch"] == 0
    assert result.state.step == 12
    plain = api.train(_tiny(), device="cpu", verbose=False)
    assert result.history[0]["test_elbo"] != plain.history[0]["test_elbo"]


def test_nan_rollback_requires_workdir():
    with pytest.raises(ValueError, match="workdir"):
        api.train(_tiny(nan_rollback=1), device="cpu", verbose=False)


def test_nan_rollback_off_keeps_the_old_behaviour(tmp_path):
    """With ``nan_rollback=0`` a blast is evaluated and recorded as it is,
    nothing rolls back and the run does not raise."""
    wd = str(tmp_path)
    result = api.train(_tiny(), wd, device="cpu", verbose=False, fault_hook=_blast_once(2))
    assert [r["epoch"] for r in result.history] == [1, 2, 3, 4]
    assert math.isfinite(result.history[0]["test_elbo"])
    assert all(math.isnan(r["test_elbo"]) for r in result.history[1:])
    assert _records(wd, "event") == []
    assert latest_epoch(wd) == 4
