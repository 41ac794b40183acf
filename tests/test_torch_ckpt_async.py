"""The port's overlapped checkpoint writer on the CPU, after
``tests/test_checkpoint_layout.py``'s ``AsyncCheckpointWriter`` tests.

``AsyncCheckpointWriter.stage`` snapshots the state (clones on the CPU; on
the card, clones and a copy to pinned host memory ordered by an event,
which ``tests/test_torch_graphs.py`` runs there) and a worker thread writes
it with ``save_checkpoint``'s disk work (``_serialize_and_flip``). Every
state is a tiny MNIST model (8 latents); the runs a second or two each.
"""

import json
import os
import threading
import time
from unittest import mock

import pytest
import torch

from mmvae_torch import api, configs
from mmvae_torch.models import MnistMVAE
from mmvae_torch.train import checkpoint, create_train_state
from mmvae_torch.train.checkpoint import (
    AsyncCheckpointWriter,
    latest_epoch,
    load_checkpoint,
    save_checkpoint,
)
from torch_threads import _one_torch_thread  # noqa: F401


def _state(seed: int = 0, **kw):
    model = MnistMVAE(n_latents=8)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return create_train_state(model, 1e-3, **kw)


def _params(state) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in state.model.named_parameters()}


def _assert_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _tree(workdir: str, which: str = "last") -> dict:
    path = checkpoint._resolve_ckpt_path(os.path.join(workdir, "ckpt"), which)
    return torch.load(os.path.join(path, checkpoint.STATE_FILE), weights_only=True)


def _trees_equal(a, b) -> None:
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _trees_equal(x, y)
    else:
        assert a == b


def test_async_writer_roundtrip_matches_sync(tmp_path):
    """stage -> worker -> finalize writes what the synchronous save writes
    (the whole tree, the pointer and the best alias), the pointer flipping
    only once the worker is done; a save point that comes while the worker
    is busy is skipped."""
    state = _state(ema_decay=0.5, accum_steps=2)
    generators = {"order": torch.Generator().manual_seed(3)}
    wd = str(tmp_path / "async")
    writer = AsyncCheckpointWriter(wd)
    gate = threading.Event()
    real = checkpoint._serialize_and_flip

    def gated(*a, **kw):
        gate.wait(timeout=30)
        return real(*a, **kw)

    with mock.patch.object(checkpoint, "_serialize_and_flip", gated):
        assert writer.stage(state, 1, is_best=True, extra={"best_test_elbo": -1.0},
                            generators=generators)
        assert not writer.stage(state, 2)
        assert writer.skipped == 1 and writer.busy
        writer.poll()  # does not wait for the save in flight
        assert latest_epoch(wd) is None
        gate.set()
        writer.finalize()
    assert writer.saved == 1 and latest_epoch(wd) == 1
    wd_sync = str(tmp_path / "sync")
    save_checkpoint(wd_sync, state, 1, is_best=True, extra={"best_test_elbo": -1.0},
                    generators=generators)
    _trees_equal(_tree(wd), _tree(wd_sync))
    with open(os.path.join(wd, "ckpt", "last_meta.json")) as f, \
            open(os.path.join(wd_sync, "ckpt", "last_meta.json")) as g:
        assert json.load(f) == json.load(g)
    loaded, extra = load_checkpoint(wd, _state(seed=1, ema_decay=0.5, accum_steps=2), "best")
    assert extra["epoch"] == 1 and extra["best_test_elbo"] == -1.0
    _assert_equal(_params(loaded), _params(state))


@pytest.mark.parametrize("surface", ["poll", "drain", "finalize"])
def test_async_writer_worker_failure_surfaces(tmp_path, surface):
    """A failed overlapped save raises at the next poll, drain or
    finalize, never silently."""
    writer = AsyncCheckpointWriter(str(tmp_path))
    with mock.patch.object(checkpoint, "_serialize_and_flip",
                           side_effect=RuntimeError("disk full")):
        assert writer.stage(_state(), 1)
        for _ in range(200):
            if not writer.busy:
                break
            time.sleep(0.05)
        with pytest.raises(RuntimeError, match="disk full"):
            getattr(writer, surface)()
    writer.finalize()
    assert writer.saved == 0


def test_async_snapshot_survives_the_next_epochs_updates(tmp_path):
    """The staged snapshot is a copy: the live parameters, moments and
    running mean updated in place after ``stage`` (as the next epoch does)
    leave the saved values as they were."""
    state = _state(accum_steps=2)
    for p, acc in zip(state.model.parameters(), state.acc_grads):
        acc.fill_(0.25)
        p.grad = torch.ones_like(p)
    state.apply_gradients(commit=True)
    want, want_acc = _params(state), [a.clone() for a in state.acc_grads]
    want_adam = {k: v.clone() for k, v in state.optimizer.state[next(state.model.parameters())].items()}
    writer = AsyncCheckpointWriter(str(tmp_path))
    gate = threading.Event()
    real = checkpoint._serialize_and_flip
    with mock.patch.object(checkpoint, "_serialize_and_flip",
                           lambda *a, **kw: (gate.wait(timeout=30), real(*a, **kw))):
        assert writer.stage(state, 1)
        with torch.no_grad():
            for p in state.model.parameters():
                p.mul_(0).sub_(7.0)
            for v in state.optimizer.state.values():
                v["exp_avg"].fill_(3.0)
            for a in state.acc_grads:
                a.fill_(5.0)
        gate.set()
        writer.finalize()
    loaded, _ = load_checkpoint(str(tmp_path), _state(seed=1, accum_steps=2), which="last")
    _assert_equal(_params(loaded), want)
    for a, b in zip(loaded.acc_grads, want_acc):
        assert torch.equal(a, b)
    got_adam = loaded.optimizer.state[next(loaded.model.parameters())]
    _assert_equal(dict(got_adam), want_adam)


def _lines(wd, kind=None):
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        return [{k: v for k, v in r.items() if k not in ("time", "ckpt_saved", "ckpt_skipped")}
                for r in map(json.loads, f) if kind is None or r["kind"] == kind]


def test_train_ckpt_async_end_to_end_equals_sync(tmp_path):
    """``ckpt_async`` end to end: the history, ``metrics.jsonl`` and the
    final checkpoint equal the synchronous run's bit for bit; the eval
    records carry the writer's counts; every epoch but the last was staged
    and the last saved synchronously; eval and resume read the workdir."""
    cfg = configs.get_config("mnist").replace(
        n_latents=8, epochs=3, train_size=60, test_size=30, batch_size=20,
        annealing_epochs=1, accum_steps=2, ema_decay=0.5)
    wd, wd_sync = str(tmp_path / "async"), str(tmp_path / "sync")
    staged = []
    real_stage = AsyncCheckpointWriter.stage

    def stage(self, state, epoch, **kw):
        staged.append(epoch)
        return real_stage(self, state, epoch, **kw)

    with mock.patch.object(AsyncCheckpointWriter, "stage", stage):
        result = api.train(cfg.replace(ckpt_async=True), wd, device="cpu", verbose=False)
    sync = api.train(cfg, wd_sync, device="cpu", verbose=False)
    assert staged == [1, 2]
    assert result.history == sync.history
    assert _lines(wd) == _lines(wd_sync)
    evals = [json.loads(x) for x in open(os.path.join(wd, "metrics.jsonl"))
             if json.loads(x)["kind"] == "eval"]
    assert all({"ckpt_saved", "ckpt_skipped"} <= set(r) for r in evals)
    # Each eval record comes before its epoch's save point: it counts the
    # stages of the epochs before it that the worker finished or skipped.
    done = [r["ckpt_saved"] + r["ckpt_skipped"] for r in evals]
    assert done[0] == 0 and done == sorted(done)
    assert all(n <= r["epoch"] - 1 for n, r in zip(done, evals))
    assert latest_epoch(wd) == 3
    _trees_equal(_tree(wd), _tree(wd_sync))
    assert api.eval_elbo("mnist", workdir=wd, device="cpu") == api.eval_elbo(
        "mnist", workdir=wd_sync, device="cpu")
    more = api.train(cfg.replace(ckpt_async=True, epochs=4), wd, device="cpu", verbose=False,
                     resume=True)
    assert [r["epoch"] for r in more.history] == [4]
