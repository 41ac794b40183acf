"""The port's shuffle modes against the JAX ``make_gather_epoch_runner``, on
the CPU, on one device.

The JAX runner draws its order from ``state.rng`` inside its program
(``mmvae_tpu/train/step.py:1306-1530``); ``jax.random`` cannot be drawn in
torch, so the test takes each epoch's draws from the same keys, in the
runner's split sequence (``split(state.rng, 4)``: the order, the roll
offset or block order, the group offset), and passes them to the port's
``epoch_order``. The JAX side runs its real runner over a split whose one
modality is each row's index, with the step body replaced by one that
records its batch and advances ``step`` and ``rng`` as the real step does:
so the rows every step of four epochs sees are compared, at
``reshuffle_every`` 1 and 3, ``"roll"`` and ``"block"``, and groups of 1,
4 and 7 rows (7 does not divide the 60 rows: exact rows). The port's
draws from its own generator are held to the properties instead: a roll
is a rotation, a block epoch the last shuffle's batches in a new order,
a group shuffle G-row groups after an offset below G.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from mmvae_tpu.train import step as jstep
from mmvae_torch import api, configs
from mmvae_torch.train import epoch_order, step as tstep
from torch_threads import _one_torch_thread  # noqa: F401

SIZE, BS = 60, 8
N_STEPS = SIZE // BS  # 7 steps; 4 rows left out
EPOCHS = 4


@struct.dataclass
class _State:
    step: jax.Array
    rng: jax.Array


def _recording_impl(model, **kw):
    """The JAX step body with its work taken out: the batch's row indices
    as its metric, ``step`` + 1 and ``rng`` the third of ``split(rng, 3)``,
    as ``_train_step_impl``'s step leaves them."""
    def impl(state, batch):
        return state.replace(step=state.step + 1,
                             rng=jax.random.split(state.rng, 3)[2]), {"rows": batch["rows"]}
    return impl


def _jax_epochs(monkeypatch, reshuffle_every, mode, gran):
    """The rows each step of each epoch reads in the JAX runner, and each
    epoch's draws."""
    monkeypatch.setattr(jstep, "_train_step_impl", _recording_impl)
    run = jstep.make_gather_epoch_runner(None, N_STEPS, BS, reshuffle_every=reshuffle_every,
                                         shuffle_mode=mode, shuffle_granularity=gran)
    state = _State(step=jnp.int32(0), rng=jax.random.key(11))
    arrays = {"rows": jnp.arange(SIZE, dtype=jnp.int32)}
    rows, draws = [], []
    for e in range(EPOCHS):
        shuffle_rng, roll_rng, off_rng, _ = jax.random.split(state.rng, 4)
        grouped = gran > 1 and SIZE % gran == 0
        draws.append({
            "order": np.array(jax.random.permutation(
                shuffle_rng, SIZE // gran if grouped else SIZE)),
            "group_offset": int(jax.random.randint(off_rng, (), 0, gran)),
            "roll_offset": int(jax.random.randint(roll_rng, (), 1, SIZE)),
            "block_order": np.array(jax.random.permutation(roll_rng, N_STEPS)),
        })
        state, arrays, ms = run(state, arrays, e == 0)
        rows.append(np.asarray(ms["rows"]))
    return rows, draws


@pytest.mark.parametrize("gran", [1, 4, 7])
@pytest.mark.parametrize("mode", ["roll", "block"])
@pytest.mark.parametrize("reshuffle_every", [1, 3])
def test_every_step_reads_the_rows_jax_reads(monkeypatch, reshuffle_every, mode, gran):
    want, draws = _jax_epochs(monkeypatch, reshuffle_every, mode, gran)
    pos = torch.arange(SIZE)
    for e in range(EPOCHS):
        pos, rows = epoch_order(pos, e, N_STEPS, BS, reshuffle_every=reshuffle_every,
                                shuffle_mode=mode, shuffle_granularity=gran,
                                force_shuffle=e == 0, draws=draws[e])
        np.testing.assert_array_equal(rows.numpy(), want[e], err_msg=f"epoch {e}")


def _recording_runner(seen):
    """``make_epoch_runner``'s stand-in: records the batches, advances the
    state's step by their rows."""
    def make(model, graph=None, **kw):
        def run(state, batches):
            seen.append(batches["rows"].clone())
            state.step += N_STEPS
            return state, {"loss": torch.zeros(N_STEPS)}
        return run
    return make


def _port_epochs(monkeypatch, epochs=EPOCHS, seed=0, **kw):
    """The rows each epoch of the port's runner reads, its draws from a
    seeded generator, and the arrangement before and after each epoch."""
    seen = []
    monkeypatch.setattr(tstep, "make_epoch_runner", _recording_runner(seen))
    run = tstep.make_gather_epoch_runner(None, N_STEPS, BS,
                                         order=torch.Generator().manual_seed(seed), **kw)
    state, pos, arrangement = types.SimpleNamespace(step=0), None, [torch.arange(SIZE)]
    for e in range(epochs):
        state, pos, _ = run(state, {"rows": torch.arange(SIZE)}, pos, e == 0)
        arrangement.append(pos)
    assert state.step == epochs * N_STEPS
    return seen, arrangement


def test_roll_epochs_rotate_the_persisted_order(monkeypatch):
    seen, pos = _port_epochs(monkeypatch, epochs=6, reshuffle_every=3, shuffle_mode="roll")
    for e in (1, 2, 4, 5):  # between the true shuffles at 0 and 3
        shifts = [k for k in range(1, SIZE) if torch.equal(torch.roll(pos[e], k), pos[e + 1])]
        assert len(shifts) == 1, e
        assert torch.equal(seen[e].flatten(), pos[e + 1][:N_STEPS * BS])
    assert sorted(pos[4].tolist()) == list(range(SIZE)) and not torch.equal(pos[4], pos[3])


def test_block_epochs_reorder_the_last_shuffle_s_batches(monkeypatch):
    seen, pos = _port_epochs(monkeypatch, epochs=6, reshuffle_every=3, shuffle_mode="block")
    for e in (1, 2, 4, 5):
        assert torch.equal(pos[e + 1], pos[e])
        shuffled = seen[3 if e > 3 else 0]
        assert sorted(map(tuple, seen[e].tolist())) == sorted(map(tuple, shuffled.tolist()))
        assert not torch.equal(seen[e], shuffled)


@pytest.mark.parametrize("gran", [4, 7])
def test_group_shuffles_move_whole_groups(monkeypatch, gran):
    """G = 4 divides the 60 rows: each true shuffle is the last arrangement
    rolled by an offset below 4, its 4-row groups permuted. G = 7 does not:
    a permutation of single rows."""
    _, pos = _port_epochs(monkeypatch, epochs=3, shuffle_granularity=gran)
    for e in range(3):
        before, after = pos[e], pos[e + 1]
        assert sorted(after.tolist()) == list(range(SIZE))
        if gran == 7:
            continue
        groups = {tuple(g) for g in after.reshape(-1, gran).tolist()}
        offsets = [off for off in range(gran)
                   if {tuple(g) for g in torch.roll(before, off).reshape(-1, gran).tolist()}
                   == groups]
        assert offsets, e


def test_the_defaults_draw_a_fresh_permutation_each_epoch(monkeypatch):
    """At ``reshuffle_every`` 1 and groups of 1, ``api.train`` does not
    persist the order: each epoch reads the head of a fresh permutation of
    the loaded split, drawn from the order generator in turn."""
    gen = torch.Generator().manual_seed(0)
    seen = []
    monkeypatch.setattr(tstep, "make_epoch_runner", _recording_runner(seen))
    run = tstep.make_gather_epoch_runner(None, N_STEPS, BS, order=torch.Generator().manual_seed(0))
    state = types.SimpleNamespace(step=0)
    for _ in range(3):
        state, _, _ = run(state, {"rows": torch.arange(SIZE)}, None)
    for rows in seen:
        assert torch.equal(rows.flatten(), torch.randperm(SIZE, generator=gen)[:N_STEPS * BS])


@pytest.mark.parametrize("kw", [dict(reshuffle_every=4, shuffle_mode="roll"),
                                dict(reshuffle_every=4, shuffle_mode="block"),
                                dict(shuffle_granularity=4),
                                dict(reshuffle_every=2, shuffle_mode="block",
                                     shuffle_granularity=7)])
def test_api_train_runs_each_mode(kw):
    """Five epochs of ``api.train`` in each mode: a finite history, the
    step count of five whole epochs, and the same history again from the
    same seed."""
    cfg = configs.get_config("mnist").replace(n_latents=8, epochs=5, train_size=SIZE,
                                               test_size=16, batch_size=BS, **kw)
    first = api.train(cfg, device="cpu", verbose=False)
    assert first.state.step == 5 * N_STEPS
    assert np.isfinite([r["train_loss"] for r in first.history]).all()
    assert api.train(cfg, device="cpu", verbose=False).history == first.history


def test_an_unknown_shuffle_mode_raises():
    with pytest.raises(ValueError, match="unknown shuffle_mode"):
        tstep.make_gather_epoch_runner(None, N_STEPS, BS, shuffle_mode="window")
    with pytest.raises(ValueError, match="unknown shuffle_mode"):
        epoch_order(torch.arange(SIZE), 0, N_STEPS, BS, shuffle_mode="window")
