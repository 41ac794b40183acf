"""The tensor form of the KL annealing factor, the train step's beta, and
the runners' CPU path, on the CPU.

``annealing_factor`` reads the train state's device step, so that a CUDA
graph replay computes its own beta; its value must be the JAX one's to the
bit at every step, the last step of the ramp and the one after it
included. On the CPU the runners are eager loops (the graphs are the
card's: ``tests/test_torch_graphs.py``).
"""

import numpy as np
import pytest
import torch

from mmvae_tpu.core.annealing import annealing_factor as j_annealing_factor
from mmvae_torch.core import annealing_factor
from mmvae_torch.data import make_mnist
from mmvae_torch.models import MnistMVAE
from mmvae_torch.train import create_train_state, make_epoch_runner, make_train_step
from torch_threads import _one_torch_thread  # noqa: F401


def _steps(annealing_steps: int) -> list[int]:
    """Steps 0 and 1, the last step of the ramp, its end and the step after."""
    return [0, 1, annealing_steps - 1, annealing_steps, annealing_steps + 1]


@pytest.mark.parametrize("annealing_steps", [40, 7, 3000, 0, -5])
def test_tensor_annealing_factor_equals_jax_at_the_ramp_points(annealing_steps):
    for step in _steps(max(annealing_steps, 2)):
        got = annealing_factor(torch.tensor(step, dtype=torch.int64), annealing_steps)
        want = np.asarray(j_annealing_factor(step, annealing_steps))
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.numpy().tobytes() == want.astype(np.float32).tobytes(), step


def test_tensor_annealing_factor_equals_jax_over_a_whole_ramp():
    steps = torch.arange(0, 1205, dtype=torch.int64)
    got = torch.stack([annealing_factor(s, 1200) for s in steps]).numpy()
    want = np.array([np.asarray(j_annealing_factor(int(s), 1200)) for s in steps], np.float32)
    np.testing.assert_array_equal(got, want)


def _tiny(seed: int = 0):
    model = MnistMVAE(n_latents=8)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def _batch(n: int = 4) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in make_mnist(n, seed=3).items()}


def test_the_train_step_reads_beta_from_the_device_step():
    """beta is the device step's, whatever the host step says; both
    advance by one a step."""
    model = _tiny()
    state = create_train_state(model, 1e-3)
    state.step, state.device_step = 0, torch.tensor(6, dtype=torch.int64)
    step = make_train_step(model, annealing_steps=8, generator=torch.Generator().manual_seed(0))
    betas = [step(state, _batch())[1]["beta"] for _ in range(3)]
    want = [np.asarray(j_annealing_factor(s, 8)) for s in (6, 7, 8)]
    assert [b.item() for b in betas] == [float(w) for w in want] == [0.75, 0.875, 1.0]
    assert state.step == 3 and int(state.device_step) == 9


def test_the_cpu_runner_is_the_eager_loop_and_refuses_a_graph():
    """On the CPU ``graph=None`` and ``graph=False`` give the same eager
    loop; ``graph=True`` raises, as a CUDA graph needs the card."""
    batches = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in _batch().items()}
    runs = []
    for graph in (None, False):
        model = _tiny()
        state = create_train_state(model, 1e-3)
        gen = torch.Generator().manual_seed(1)
        state, metrics = make_epoch_runner(model, graph=graph, annealing_steps=3,
                                           generator=gen)(state, batches)
        runs.append((metrics, dict(model.named_parameters())))
    for k in runs[0][0]:
        assert torch.equal(runs[0][0][k], runs[1][0][k])
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k])
    with pytest.raises(ValueError, match="needs the model on the card"):
        make_epoch_runner(_tiny(), graph=True)


def test_the_runner_takes_each_steps_noise_from_the_batches():
    """Stacked ``eps`` feeds each step its noise, as ``eps=`` feeds one
    step: the same bits, and no draw from the generator."""
    batches = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in _batch().items()}
    eps = torch.randn((2, 3, 2, 8), generator=torch.Generator().manual_seed(4))
    model = _tiny()
    state = create_train_state(model, 1e-3)
    gen = torch.Generator().manual_seed(1)
    before = gen.get_state()
    _, metrics = make_epoch_runner(model, annealing_steps=3, generator=gen)(
        state, dict(batches, eps=eps))
    assert torch.equal(gen.get_state(), before)
    model_b = _tiny()
    state_b = create_train_state(model_b, 1e-3)
    step = make_train_step(model_b, annealing_steps=3)
    losses = [step(state_b, {k: v[i] for k, v in batches.items()}, eps=eps[i])[1]["loss"]
              for i in range(2)]
    assert torch.equal(metrics["loss"], torch.stack(losses))
    for a, b in zip(model.parameters(), model_b.parameters()):
        assert torch.equal(a, b)
