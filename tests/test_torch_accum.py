"""The port's gradient accumulation and cosine LR schedule against the JAX
package, on the CPU.

The JAX ``MnistMVAE`` (n_latents 16, the 512-wide experts) is initialised
from a seed and its parameters move across with
``convert.from_flax_params``; both sides see the same numpy batches of 8.
The posterior noise of each micro-step is the JAX step's own draw
(``jax.random.normal`` of the key ``multi_term_loss`` splits off),
handed to the port as ``eps``. The JAX state is ``create_train_state(...,
accum_steps=k)`` (``optax.MultiSteps`` around clipping and Adam) stepped by
``make_train_step``; the port's is ``create_train_state(...,
accum_steps=k)`` stepped by ``make_train_step``, and by the epoch runner
over two calls whose boundary falls inside an update.

Tolerances (rtol 2e-4, as the MNIST training slice): the loss at rtol
2e-4 and the raw gradient norm at rtol 1e-4 each micro-step, beta
exactly; the parameters and the EMA parameters by the relative 2-norm of
their difference against the JAX update (1e-4) and elementwise within
1e-4; the running mean of the gradients and Adam's moments at rtol 2e-4
with an atol of 2e-4 of each tensor's largest element (a component at its
rounding level), as the slice's gradients. The schedule's rate at every
update at rtol 1e-6 with an atol of 1e-10: both sides compute it in
float32, and one rounding of the cosine (6e-8) times the peak rate 1e-3
is the absolute error left where ``1 + cos`` cancels near the end of the
decay.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmvae_tpu.api import _learning_rate as j_learning_rate
from mmvae_tpu.configs import get_config as j_get_config
from mmvae_tpu.models import MnistMVAE as JMnistMVAE
from mmvae_tpu.train.state import create_train_state as j_create_train_state
from mmvae_tpu.train.step import make_train_step as j_make_train_step
from mmvae_torch import api, configs
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import make_mnist
from mmvae_torch.models import MnistMVAE
from mmvae_torch.train import create_train_state, make_epoch_runner, make_train_step
from mmvae_torch.train.state import learning_rate

N_LATENTS, B, T = 16, 8, 3
RTOL = 2e-4
STEP_REL = 1e-4
STEP_ATOL = 1e-4
ANNEALING = 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(n: int, seed: int = 5):
    data = make_mnist(n * B, seed=seed)
    return [{k: v[i * B:(i + 1) * B] for k, v in data.items()} for i in range(n)]


def _tbatch(batch) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _eps(state_rng) -> torch.Tensor:
    """The noise of the JAX train step of ``state_rng`` (``step.py:1045``,
    then ``multi_term_loss``'s split)."""
    rng = jax.random.split(state_rng, 3)[0]
    return torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.split(rng)[1], (T, B, N_LATENTS))))


def _adam(opt_state) -> optax.ScaleByAdamState:
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam


@pytest.fixture(scope="module")
def jmodel():
    return JMnistMVAE(n_latents=N_LATENTS)


def _tmodel(params) -> MnistMVAE:
    model = MnistMVAE(n_latents=N_LATENTS)
    model.load_state_dict(from_flax_params(_np_tree(params)))
    return model


def _close_to_update(got: dict[str, torch.Tensor], want, init, what: str) -> None:
    """``got`` against JAX's tree ``want``, both moved from the tree
    ``init``: the relative 2-norm of the difference against the update,
    and each element within STEP_ATOL."""
    want, init = from_flax_params(_np_tree(want)), from_flax_params(_np_tree(init))
    assert set(got) == set(want)
    diff = sum(((got[k].detach() - w) ** 2).sum() for k, w in want.items())
    update = sum(((w - init[k]) ** 2).sum() for k, w in want.items())
    if update == 0:  # no update yet, or one at rate 0
        assert diff == 0, what
    else:
        assert (diff / update).sqrt() < STEP_REL, what
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=0,
                                   atol=STEP_ATOL, err_msg=f"{what}: {k}")


def _grads_close(got: dict[str, torch.Tensor], want, what: str) -> None:
    want = from_flax_params(_np_tree(want))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=RTOL,
                                   atol=2e-4 * w.abs().max().item(), err_msg=f"{what}: {name}")


def _moments_close(state, j_adam) -> None:
    for key, tree in (("exp_avg", j_adam.mu), ("exp_avg_sq", j_adam.nu)):
        got = {name: state.optimizer.state[p][key] if p in state.optimizer.state
               else torch.zeros_like(p) for name, p in state.model.named_parameters()}
        _grads_close(got, tree, key)


def _jax_run(jmodel, batches, k, lr, grad_clip, ema_decay):
    state = j_create_train_state(
        jmodel, {kk: jnp.asarray(v) for kk, v in batches[0].items()}, jax.random.key(7), lr,
        grad_clip=grad_clip, ema_decay=ema_decay, accum_steps=k)
    init = _np_tree(state.params)
    step = j_make_train_step(jmodel, annealing_steps=ANNEALING, term_fold="t")
    return state, init, step


def _cosine(steps_per_epoch: int, k: int, warmup_epochs: int, epochs: int):
    """The JAX config and the two schedules of a cosine run."""
    j_cfg = j_get_config("mnist").replace(
        lr_schedule="cosine", accum_steps=k, warmup_epochs=warmup_epochs, epochs=epochs)
    t_cfg = configs.get_config("mnist").replace(
        lr_schedule="cosine", accum_steps=k, warmup_epochs=warmup_epochs, epochs=epochs)
    return j_learning_rate(j_cfg, steps_per_epoch), learning_rate(t_cfg, steps_per_epoch)


@pytest.mark.parametrize("k, schedule", [(2, "constant"), (3, "constant"), (3, "cosine")])
def test_accumulated_micro_steps_match_jax(jmodel, k, schedule):
    """Seven micro-steps (three updates of k = 2, two of k = 3 and one in
    progress), clipping at 1 (it fires: the norms are in the hundreds) and
    EMA 0.9: at every micro-step the metrics, the parameters, the running
    mean, Adam's moments and the EMA parameters against JAX's. Under the
    cosine schedule (3 micro-steps an epoch, warmup 1 epoch of 3 epochs)
    the first update runs at rate 0: the parameters stay, the moments
    move."""
    n = 7
    batches = _batches(n)
    j_lr, t_lr = 1e-3, 1e-3
    if schedule == "cosine":
        j_lr, t_lr = _cosine(3, k, warmup_epochs=1, epochs=3)
    j_state, init, j_step = _jax_run(jmodel, batches, k, j_lr, 1.0, 0.9)
    model = _tmodel(init)
    state = create_train_state(model, t_lr, grad_clip=1.0, ema_decay=0.9, accum_steps=k)
    step = make_train_step(model, annealing_steps=ANNEALING)
    for i, batch in enumerate(batches):
        eps = _eps(j_state.rng)
        j_state, j_metrics = j_step(j_state, {kk: jnp.asarray(v) for kk, v in batch.items()})
        state, metrics = step(state, _tbatch(batch), eps=eps)
        assert metrics["beta"].item() == float(j_metrics["beta"])
        np.testing.assert_allclose(metrics["loss"].item(), float(j_metrics["loss"]), rtol=RTOL)
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(j_metrics["grad_norm"]),
                                   rtol=1e-4)
        assert state.step == int(j_state.step) == i + 1
        assert state.micro_step == int(j_state.opt_state.mini_step)
        _close_to_update(state.params, j_state.params, init, f"params after micro-step {i}")
        _close_to_update(state.ema_params, j_state.ema_params, init, f"EMA after micro-step {i}")
        _grads_close(dict(zip(state.params, state.acc_grads)), j_state.opt_state.acc_grads,
                     f"running mean after micro-step {i}")
        _moments_close(state, _adam(j_state.opt_state))
        if schedule == "cosine" and i == k - 1:  # the first update, at rate 0
            for name, p in state.params.items():
                assert torch.equal(p, from_flax_params(_np_tree(init))[name]), name
            assert any(s["exp_avg"].abs().max() > 0 for s in state.optimizer.state.values())
    assert int(_adam(j_state.opt_state).count) == n // k


@pytest.mark.parametrize("k", [2, 3])
def test_epoch_runner_straddles_an_update_as_the_steps_do(jmodel, k):
    """The epoch runner over two calls of 4 and 3 rows (an update of k = 3
    spans the boundary; one of k = 2 does not, and the second call starts
    mid-update for neither) lands on the bits the same micro-steps give
    taken one at a time: the metrics, the parameters, the running mean and
    the EMA."""
    batches = _batches(7)
    init = _np_tree(jmodel.init(jax.random.key(0), {kk: jnp.asarray(v) for kk, v in
                                                    batches[0].items()},
                                rng=jax.random.key(1))["params"])
    eps = torch.randn((7, T, B, N_LATENTS), generator=torch.Generator().manual_seed(3))
    stacked = {kk: torch.from_numpy(np.stack([b[kk] for b in batches])) for kk in batches[0]}
    stacked["eps"] = eps

    model = _tmodel(init)
    state = create_train_state(model, 1e-3, grad_clip=1.0, ema_decay=0.9, accum_steps=k)
    runner = make_epoch_runner(model, annealing_steps=ANNEALING)
    state, m1 = runner(state, {kk: v[:4] for kk, v in stacked.items()})
    assert state.micro_step == 4 % k
    state, m2 = runner(state, {kk: v[4:] for kk, v in stacked.items()})

    model_b = _tmodel(init)
    state_b = create_train_state(model_b, 1e-3, grad_clip=1.0, ema_decay=0.9, accum_steps=k)
    step = make_train_step(model_b, annealing_steps=ANNEALING)
    losses = []
    for i, batch in enumerate(batches):
        state_b, metrics = step(state_b, _tbatch(batch), eps=eps[i])
        losses.append(metrics["loss"])
    assert torch.equal(torch.cat([m1["loss"], m2["loss"]]), torch.stack(losses))
    assert state.step == state_b.step == 7 and int(state.device_step) == 7
    for a, b in ((state.params, state_b.params), (state.ema_params, state_b.ema_params)):
        for name in a:
            assert torch.equal(a[name], b[name]), name
    for a, b in zip(state.acc_grads, state_b.acc_grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("steps_per_epoch, k, warmup_epochs, epochs",
                         [(20, 3, 1, 3), (20, 1, 0, 3), (7, 2, 2, 5), (1, 4, 0, 2), (100, 1, 3, 10)])
def test_cosine_rate_at_every_update_matches_jax(steps_per_epoch, k, warmup_epochs, epochs):
    """The port's schedule against ``mmvae_tpu.api._learning_rate`` at every
    update count of the run and past its end: warmup over whole epochs of
    updates (``steps_per_epoch // k``, at least 1), none
    (``warmup_epochs=0``: one update of warmup), and a split of fewer steps
    than k. The first update's rate is 0."""
    j_sched, t_sched = _cosine(steps_per_epoch, k, warmup_epochs, epochs)
    updates = max(1, steps_per_epoch // k) * epochs
    counts = np.arange(updates + 3)
    want = np.array([float(j_sched(jnp.int32(c))) for c in counts], np.float32)
    got = t_sched(torch.from_numpy(counts)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-10)
    assert got[0] == 0.0 and got[-1] == 0.0
    assert want.max() == pytest.approx(1e-3)


def test_constant_and_unknown_schedules():
    cfg = configs.get_config("mnist")
    assert learning_rate(cfg, 100) == cfg.learning_rate
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        learning_rate(cfg.replace(lr_schedule="linear"), 100)


def test_lr_in_adam_follows_the_update_count():
    """On the CPU the scheduled rate is a float Adam reads: after each
    update it is the schedule's value at the count before it."""
    cfg = configs.get_config("mnist").replace(
        n_latents=8, lr_schedule="cosine", warmup_epochs=1, epochs=2, accum_steps=2)
    sched = learning_rate(cfg, 4)  # 2 updates an epoch
    model = configs.build_model(cfg.replace(), seed=0, device="cpu")
    state = create_train_state(model, sched, accum_steps=2)
    step = make_train_step(model)
    batches = _batches(8)
    rates = []
    for i, batch in enumerate(batches):
        small = {kk: v for kk, v in _tbatch(batch).items()}
        state, _ = step(state, small, eps=torch.zeros(T, B, 8))
        if i % 2 == 1:
            rates.append(state.optimizer.param_groups[0]["lr"])
    want = [float(sched(torch.tensor(c))) for c in range(4)]
    assert rates == want and rates[0] == 0.0 and 0 < rates[1]


TINY = dict(n_latents=8, test_size=30, batch_size=20, grad_clip=1.0, ema_decay=0.9,
            accum_steps=3, lr_schedule="cosine", warmup_epochs=1, p_modality_drop=0.3)


class _Preempted(Exception):
    pass


def _run_until(cfg, workdir, last_epoch: int):
    """``cfg`` into ``workdir``, stopped after ``last_epoch``'s checkpoint
    (a preemption inside the next epoch, before its save)."""
    def hook(epoch, state):
        if epoch > last_epoch:
            raise _Preempted
        return state

    with pytest.raises(_Preempted):
        api.train(cfg, workdir, device="cpu", verbose=False, fault_hook=hook)


def test_resume_mid_accumulation_equals_an_uninterrupted_run(tmp_path):
    """Five micro-steps an epoch with k = 3: every epoch ends inside an
    update. A run stopped after epoch 2 and resumed equals three epochs in
    one call bit for bit: the parameters, the running mean, Adam's moments,
    the EMA, the history and ``metrics.jsonl``."""
    cfg = configs.get_config("mnist").replace(train_size=100, epochs=3, **TINY)
    full = api.train(cfg, str(tmp_path / "full"), device="cpu", verbose=False)
    _run_until(cfg, str(tmp_path / "split"), 2)
    resumed = api.train(cfg, str(tmp_path / "split"), device="cpu", verbose=False, resume=True)
    assert full.state.step == resumed.state.step == 15 and resumed.state.micro_step == 0
    assert [r["epoch"] for r in resumed.history] == [3]
    assert resumed.history == full.history[2:]
    for a, b in ((full.state.params, resumed.state.params),
                 (full.state.ema_params, resumed.state.ema_params)):
        for name in a:
            assert torch.equal(a[name], b[name]), name
    for a, b in zip(full.state.acc_grads, resumed.state.acc_grads):
        assert torch.equal(a, b)
    for p, q in zip(full.state.model.parameters(), resumed.state.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(full.state.optimizer.state[p][key],
                               resumed.state.optimizer.state[q][key])
    lines = []
    for name in ("full", "split"):
        text = (tmp_path / name / "metrics.jsonl").read_text().splitlines()
        lines.append([{k: v for k, v in json.loads(x).items() if k != "time"} for x in text])
    assert lines[0] == lines[1]


def test_a_checkpoint_mid_update_holds_the_running_mean(tmp_path):
    """The checkpoint of an epoch that ends inside an update holds the
    running mean and its micro-step; a state of another k refuses it."""
    from mmvae_torch.train.checkpoint import load_checkpoint

    cfg = configs.get_config("mnist").replace(train_size=100, epochs=2, **TINY)
    result = api.train(cfg, str(tmp_path), device="cpu", verbose=False)
    assert result.state.micro_step == 1
    assert any(a.abs().max() > 0 for a in result.state.acc_grads)
    fresh = create_train_state(configs.build_model(cfg, seed=1, device="cpu"), 1e-3,
                               accum_steps=3)
    fresh, _ = load_checkpoint(str(tmp_path), fresh, which="last")
    assert fresh.step == 10 and fresh.micro_step == 1
    for a, b in zip(fresh.acc_grads, result.state.acc_grads):
        assert torch.equal(a, b)
    other = create_train_state(configs.build_model(cfg, seed=1, device="cpu"), 1e-3,
                               accum_steps=2)
    with pytest.raises(ValueError, match="accum_steps"):
        load_checkpoint(str(tmp_path), other, which="last")


def test_api_train_with_accumulation_is_finite_and_counts_updates():
    cfg = configs.get_config("mnist").replace(train_size=100, epochs=2, **TINY)
    result = api.train(cfg, device="cpu", verbose=False)
    assert result.state.step == 10
    counts = {int(s["step"]) for s in result.state.optimizer.state.values()}
    assert counts == {3}  # 10 micro-steps of k = 3
    assert all(math.isfinite(r["test_elbo"]) for r in result.history)
