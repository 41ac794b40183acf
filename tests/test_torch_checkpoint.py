"""The port's checkpoints, resume and workdir entry points, on the CPU.

The checkpoint layout and pointer file are held against the JAX package's
own ``save_checkpoint`` run through the same sequence of saves; the rest
against the port itself: a resumed run against an uninterrupted one (bit
for bit on the CPU), the workdir entry points against the in-memory model,
and the crash windows of the save. Every run is a tiny MNIST config (8
latents, a train split of 60 in batches of 20), a second or two each.
"""

import json
import math
import os

import jax
import pytest
import torch

from mmvae_tpu.models import MnistMVAE as JMnistMVAE
from mmvae_tpu.train import create_train_state as j_create_train_state
from mmvae_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from mmvae_torch import api, configs
from mmvae_torch.models import MnistMVAE
from mmvae_torch.train import checkpoint, create_train_state
from mmvae_torch.train.checkpoint import (
    epoch_checkpoints,
    latest_epoch,
    load_checkpoint,
    save_checkpoint,
)
from torch_threads import _one_torch_thread  # noqa: F401

TINY = dict(n_latents=8, train_size=60, test_size=30, batch_size=20)


def _cfg(**kw):
    return configs.get_config("mnist").replace(**{**TINY, **kw})


def _state(ema_decay: float = 0.0, seed: int = 0):
    model = MnistMVAE(n_latents=8)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return create_train_state(model, 1e-3, ema_decay=ema_decay)


def _ckpt_view(workdir) -> tuple[list[str], dict]:
    ckpt = os.path.join(workdir, "ckpt")
    with open(os.path.join(ckpt, "last_meta.json")) as f:
        return sorted(os.listdir(ckpt)), json.load(f)


def _params(model) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _assert_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def jax_state():
    model = JMnistMVAE(n_latents=8)
    return j_create_train_state(model, model.dummy_batch(2), jax.random.key(0), 1e-3)


@pytest.mark.parametrize("keep_epochs", [0, 2])
def test_layout_and_pointer_match_the_jax_package(jax_state, tmp_path, keep_epochs):
    """Epochs 1-4, best at 1 and 3: after every save the port's ``ckpt/``
    holds the same directory names and ``last_meta.json`` as the JAX
    package's after the same save."""
    state = _state()
    for epoch, is_best in zip(range(1, 5), (True, False, True, False)):
        extra = {"best_test_elbo": 100.0 - epoch}
        j_save_checkpoint(str(tmp_path / "jax"), jax_state, epoch, is_best=is_best,
                          extra=extra, keep_epochs=keep_epochs)
        save_checkpoint(str(tmp_path / "port"), state, epoch, is_best=is_best,
                        extra=extra, keep_epochs=keep_epochs)
        assert _ckpt_view(tmp_path / "port") == _ckpt_view(tmp_path / "jax")
    assert latest_epoch(str(tmp_path / "port")) == 4
    assert epoch_checkpoints(str(tmp_path / "port")) == ([3, 4] if keep_epochs else [])


def _run_split(tmp_path, cfg, name: str):
    """``cfg`` for 1 epoch into a workdir, then resumed to ``cfg.epochs``."""
    wd = str(tmp_path / name)
    api.train(cfg.replace(epochs=1), wd, device="cpu", verbose=False)
    return api.train(cfg, wd, device="cpu", verbose=False, resume=True), wd


def _metrics_lines(wd) -> list[dict]:
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


def test_resume_is_exact_on_the_cpu(tmp_path):
    """Two epochs in one call equal one epoch and a resume of one, bit for
    bit: the parameters, Adam's moments and steps, the EMA shadow, both
    steps, the history and ``metrics.jsonl`` (presence dropout and the
    noise draw from the saved generator, the order from the other)."""
    cfg = _cfg(epochs=2, ema_decay=0.5, p_modality_drop=0.3)
    wd_full = str(tmp_path / "full")
    full = api.train(cfg, wd_full, device="cpu", verbose=False)
    split, wd_split = _run_split(tmp_path, cfg, "split")
    assert [r["epoch"] for r in split.history] == [2]
    assert split.history == full.history[1:]
    assert split.best_test_elbo == full.best_test_elbo
    _assert_equal(_params(split.state.model), _params(full.state.model))
    _assert_equal(_params(split.state.ema_model), _params(full.state.ema_model))
    for p_split, p_full in zip(split.state.model.parameters(), full.state.model.parameters()):
        s, f = split.state.optimizer.state[p_split], full.state.optimizer.state[p_full]
        _assert_equal(s, f)
    assert split.state.step == full.state.step == 6
    assert int(split.state.device_step) == 6
    assert _metrics_lines(wd_split) == _metrics_lines(wd_full)
    # Three steps an epoch at the default log_interval (100): one train
    # record an epoch (its first step), then its eval record.
    lines = _metrics_lines(wd_full)
    assert [r["kind"] for r in lines] == ["train", "eval", "train", "eval"]
    assert [r["step"] for r in lines if r["kind"] == "train"] == [1, 4]


def test_resume_of_a_finished_run_trains_nothing(tmp_path):
    cfg = _cfg(epochs=1)
    wd = str(tmp_path)
    first = api.train(cfg, wd, device="cpu", verbose=False)
    again = api.train(cfg, wd, device="cpu", verbose=False, resume=True)
    assert again.history == [] and again.state.step == first.state.step
    assert again.best_test_elbo == first.best_test_elbo
    _assert_equal(_params(again.state.model), _params(first.state.model))


def test_a_crash_between_serialize_and_flip_leaves_the_previous_checkpoint(
        tmp_path, monkeypatch):
    wd = str(tmp_path)
    state = _state()
    save_checkpoint(wd, state, 1, is_best=True)
    saved = _params(state.model)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)

    def killed(*args):
        raise KeyboardInterrupt("killed before the pointer flip")

    monkeypatch.setattr(checkpoint, "_write_meta_atomic", killed)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(wd, state, 2, is_best=True)
    monkeypatch.undo()
    assert latest_epoch(wd) == 1
    for which in ("last", "best"):
        loaded, extra = load_checkpoint(wd, _state(seed=1), which=which)
        assert extra["epoch"] == 1
        _assert_equal(_params(loaded.model), saved)


def test_a_lost_pointer_falls_back_to_the_newest_tagged_dir(tmp_path):
    wd = str(tmp_path)
    state = _state()
    save_checkpoint(wd, state, 1)
    save_checkpoint(wd, state, 2)
    os.makedirs(os.path.join(wd, "ckpt", "last_00003.tmp"))  # a save cut short
    os.remove(os.path.join(wd, "ckpt", "last_meta.json"))
    assert latest_epoch(wd) == 2
    for which in ("last", "best"):  # no best pointer: "best" falls back to "last"
        _, extra = load_checkpoint(wd, _state(seed=1), which=which)
        assert extra["epoch"] == 2


@pytest.mark.parametrize("damage", ["garbage", "truncated"])
def test_a_corrupt_checkpoint_raises(tmp_path, damage):
    wd = str(tmp_path)
    save_checkpoint(wd, _state(), 1)
    path = os.path.join(wd, "ckpt", "last_00001", checkpoint.STATE_FILE)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(b"\x00not a checkpoint" * 64 if damage == "garbage" else data[: len(data) // 2])
    with pytest.raises(Exception):
        load_checkpoint(wd, _state(seed=1), which="last")


def test_no_checkpoint_raises(tmp_path):
    assert latest_epoch(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), _state(), which="best")


def test_the_ema_toggle_across_a_save_and_a_load(tmp_path):
    """Saved without an EMA shadow and loaded into a state that tracks one:
    the shadow starts at the parameters. Saved with one and loaded into a
    state that does not: the shadow is dropped."""
    plain = _state()
    save_checkpoint(str(tmp_path / "a"), plain, 1)
    loaded, _ = load_checkpoint(str(tmp_path / "a"), _state(ema_decay=0.9, seed=1), "last")
    _assert_equal(_params(loaded.ema_model), _params(plain.model))
    _assert_equal(_params(loaded.model), _params(plain.model))

    tracked = _state(ema_decay=0.9)
    with torch.no_grad():
        for e in tracked.ema_model.parameters():
            e.mul_(0.5)
    save_checkpoint(str(tmp_path / "b"), tracked, 1)
    loaded, _ = load_checkpoint(str(tmp_path / "b"), _state(seed=1), "last")
    assert loaded.ema_model is None
    _assert_equal(_params(loaded.model), _params(tracked.model))
    loaded, _ = load_checkpoint(str(tmp_path / "b"), _state(ema_decay=0.9, seed=1), "last")
    _assert_equal(_params(loaded.ema_model), _params(tracked.ema_model))


@pytest.mark.parametrize("ckpt_every, keep", [(2, 0), (2, 1), (3, 2), (1, 2)])
def test_ckpt_every_and_keep_epoch_ckpts_prune_as_the_jax_package(
        jax_state, tmp_path, ckpt_every, keep):
    """``api.train`` over 4 epochs saves every ``ckpt_every`` epochs and at
    the last, the best pointer naming the best saved epoch; the same saves
    through the JAX ``save_checkpoint`` (the JAX ``train``'s schedule,
    ``mmvae_tpu/api.py:961-996``, on the port's test ELBOs) leave the same
    directories and pointer."""
    cfg = _cfg(epochs=4, ckpt_every=ckpt_every, keep_epoch_ckpts=keep)
    result = api.train(cfg, str(tmp_path / "port"), device="cpu", verbose=False)
    best = best_saved = float("inf")
    for record in result.history:
        epoch, elbo = record["epoch"], record["test_elbo"]
        best = min(best, elbo)
        if epoch % ckpt_every == 0 or epoch == cfg.epochs:
            j_save_checkpoint(str(tmp_path / "jax"), jax_state, epoch, is_best=elbo < best_saved,
                              extra={"best_test_elbo": best}, keep_epochs=keep)
            best_saved = min(best_saved, elbo)
    assert _ckpt_view(tmp_path / "port") == _ckpt_view(tmp_path / "jax")


@pytest.mark.parametrize("ema_decay", [0.0, 0.5])
def test_workdir_entry_points_equal_the_in_memory_model(tmp_path, ema_decay):
    """``eval_elbo``, ``generate`` and ``sample`` with ``workdir=`` read the
    best checkpoint's eval weights (the EMA shadow where tracked): their
    results equal those of ``state.eval_model``, and the ELBO the best
    epoch recorded."""
    cfg = _cfg(epochs=2, ema_decay=ema_decay)
    wd = str(tmp_path)
    result = api.train(cfg, wd, device="cpu", verbose=False)
    eval_model = result.state.eval_model
    assert (eval_model is result.state.ema_model) == (ema_decay > 0)
    got = api.eval_elbo("mnist", workdir=wd, device="cpu")
    assert got == api.eval_elbo(cfg, model=eval_model, device="cpu")
    assert got == result.best_test_elbo == min(r["test_elbo"] for r in result.history)
    labels = {"label": [1, 4, 7]}
    gen_wd = api.generate("mnist", labels, workdir=wd, device="cpu")
    gen_mem = api.generate(cfg, labels, model=eval_model, device="cpu")
    _assert_equal(gen_wd, gen_mem)
    samples = [api.sample("mnist", 5, device="cpu", generator=torch.Generator().manual_seed(3),
                          **src) for src in ({"workdir": wd}, {"model": eval_model})]
    _assert_equal(*samples)


def test_eval_elbo_which_last_and_best(tmp_path):
    """``which`` picks the checkpoint: "last" gives the last epoch's ELBO,
    "best" the best one's, whose directory the best pointer names."""
    cfg = _cfg(epochs=3)
    wd = str(tmp_path)
    result = api.train(cfg, wd, device="cpu", verbose=False)
    elbos = [r["test_elbo"] for r in result.history]
    with open(os.path.join(wd, "ckpt", "last_meta.json")) as f:
        meta = json.load(f)
    best_epoch = int(meta["best_dir"].split("_")[1])
    assert elbos[best_epoch - 1] == min(elbos)
    assert api.eval_elbo("mnist", workdir=wd, which="best", device="cpu") == min(elbos)
    assert api.eval_elbo("mnist", workdir=wd, which="last", device="cpu") == elbos[-1]


def test_the_run_config_round_trips(tmp_path):
    """``config.json`` gives back the config, tuples included (the
    multimnist model's ``conv_features``), and a workdir's config is used
    when the caller names it."""
    cfg = configs.get_config("multimnist").replace(
        n_latents=8, batch_size=8, train_size=24, test_size=16, epochs=1,
        model_kwargs=dict(conv_features=(4, 8), text_embed=8, text_hidden=16,
                          text_latent_dims=4, lambda_text=30.0))
    wd = str(tmp_path)
    assert api.load_run_config(wd) is None
    api._save_run_config(wd, cfg)
    assert api.load_run_config(wd) == cfg
    assert api._resolve_with_workdir("multimnist", wd) == cfg
    assert api._resolve_with_workdir("mnist", wd) == configs.get_config("mnist")
    model = configs.build_model(api.load_run_config(wd), device="cpu")
    assert model.n_latents == 8


def test_fault_hook_is_called_once_an_epoch_with_the_state(tmp_path):
    calls = []

    def hook(epoch, state):
        calls.append((epoch, state, state.step))
        return state

    cfg = _cfg(epochs=2)
    result = api.train(cfg.replace(epochs=1), str(tmp_path), device="cpu", verbose=False,
                       fault_hook=hook)
    result = api.train(cfg, str(tmp_path), device="cpu", verbose=False, resume=True,
                       fault_hook=hook)
    assert [c[0] for c in calls] == [1, 2]
    assert calls[1][1] is result.state
    assert [c[2] for c in calls] == [3, 6]  # after each epoch's 3 steps
    assert all(math.isfinite(r["test_elbo"]) for r in result.history)
