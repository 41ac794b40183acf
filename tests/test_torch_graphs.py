"""The CUDA-graph runners on the card: an epoch and an eval split as replays
of one captured step, held against the eager loop.

Every test here is marked ``gpu`` and skips without a card. This file
imports nothing of JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs.py

The graph and the eager loop run the same kernels in the same order on the
same inputs, so they are held to rel 1e-6 (they measured equal to the bit
on an H100); the MultiMNIST steps run on cuDNN's deterministic algorithms
on both sides.
"""

import copy
import math

import pytest
import torch

from mmvae_torch import api, configs, ops
from mmvae_torch.data import load_dataset
from mmvae_torch.ops import kernels
from mmvae_torch.train import create_train_state, make_epoch_runner, make_eval_runner
from mmvae_torch.train import step as step_module

REL = 1e-6


@pytest.fixture
def cuda():
    """The card, with TF32 off, the kernel backend on and the launch counts
    at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    ops.set_backend("kernel")
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    yield torch.device("cuda")
    ops.set_backend("auto")
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


def _batches(config, n_steps: int, bs: int, seed: int = 1) -> dict[str, torch.Tensor]:
    train = load_dataset(config.dataset, "train", n=n_steps * bs)
    idx = torch.randperm(train.size, generator=torch.Generator().manual_seed(seed)).numpy()
    return {k: torch.as_tensor(v[idx], device="cuda").reshape((n_steps, bs) + v.shape[1:])
            for k, v in train.arrays.items()}


def _train(config, graph: bool, batches, epochs: int = 2, annealing_steps: int = 1000):
    """``epochs`` runs of an epoch runner over ``batches`` from the seeded
    init: the state, each epoch's metrics and the launch counts."""
    model = configs.build_model(config, seed=0)
    state = create_train_state(model, config.learning_rate, grad_clip=config.grad_clip,
                               ema_decay=0.5)
    gen = torch.Generator(device="cuda").manual_seed(5)
    runner = make_epoch_runner(model, graph=graph, annealing_steps=annealing_steps,
                               generator=gen, **api.step_options(config))
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    per_epoch = []
    for _ in range(epochs):
        state, metrics = runner(state, batches)
        per_epoch.append(metrics)
    return state, per_epoch, dict(kernels.LAUNCHES), gen


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm()).item() if b.norm() > 0 else (a - b).norm().item()


def _assert_close_runs(got, want) -> None:
    (s_g, m_g, _, gen_g), (s_e, m_e, _, gen_e) = got, want
    for mg, me in zip(m_g, m_e):
        assert mg.keys() == me.keys()
        for k in mg:
            assert _rel(mg[k], me[k]) <= REL, k
    for params in (lambda s: s.model.named_parameters(), lambda s: s.ema_model.named_parameters()):
        for (name, a), (_, b) in zip(params(s_g), params(s_e)):
            assert _rel(a, b) <= REL, name
    assert s_g.step == s_e.step and int(s_g.device_step) == int(s_e.device_step) == s_e.step
    assert torch.equal(gen_g.get_state(), gen_e.get_state())


@pytest.mark.gpu
@pytest.mark.parametrize("name, n_steps, bs", [("mnist", 10, 100), ("multimnist", 3, 20)])
def test_graph_epoch_equals_eager_epoch(cuda, name, n_steps, bs):
    """Two epochs of replays against two of the eager loop, from the same
    weights, generator seed and batches: every metric, parameter and EMA
    parameter, both steps, and the noise generator's state after."""
    config = configs.get_config(name)
    torch.backends.cudnn.deterministic = name == "multimnist"
    batches = _batches(config, n_steps, bs)
    _assert_close_runs(_train(config, True, batches), _train(config, False, batches))


@pytest.mark.gpu
def test_beta_crosses_the_end_of_the_ramp_inside_one_graph_epoch(cuda):
    """A ramp of 5 steps in an epoch of 8: each replay reads its own beta
    from the device step, 1 from the ramp's end on."""
    config = configs.get_config("mnist")
    batches = _batches(config, 8, 100)
    _, (metrics,), _, _ = _train(config, True, batches, epochs=1, annealing_steps=5)
    want = torch.tensor([0.0, 0.2, 0.4, 0.6, 0.8, 1.0, 1.0, 1.0])  # each k / 5 in float32
    assert torch.equal(metrics["beta"].cpu(), want)
    _, (eager,), _, _ = _train(config, False, batches, epochs=1, annealing_steps=5)
    assert torch.equal(metrics["beta"], eager["beta"])


@pytest.mark.gpu
def test_launches_after_a_graph_epoch_equal_the_eager_epoch(cuda):
    """The replays add each captured launch once a replay: the counts equal
    the eager loop's (one eager step and the capture's taken back)."""
    config = configs.get_config("multimnist")
    batches = _batches(config, 3, 20)
    _, _, graph_launches, _ = _train(config, True, batches)
    _, _, eager_launches, _ = _train(config, False, batches)
    assert graph_launches == eager_launches
    assert graph_launches["poe_kl"] == 18 and graph_launches["seq_ce_bwd"] == 18


@pytest.mark.gpu
def test_eval_graph_equals_the_eager_eval(cuda):
    """A graph runner built once serves later evals of the same model,
    updated in place; each equals the eager loop's to the bit."""
    model = configs.build_model("mnist", seed=0)
    test = load_dataset("mnist", "test", n=450)
    stacked = api._padded_split(test, 100, model.n_modalities, cuda)
    graph, eager = make_eval_runner(model), make_eval_runner(model, graph=False)
    for _ in range(2):
        got, want = graph(stacked), eager(stacked)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(0.9)
    assert kernels.LAUNCHES["poe_kl"] == 2 * 2 * 5  # 2 runs of 2 runners over 5 batches


@pytest.mark.gpu
def test_resume_on_the_card_is_exact(cuda, tmp_path):
    """Two epochs in one call against one and a resume of one, on the
    card's graph runners: the history and the parameters within rel
    1e-6."""
    config = configs.get_config("mnist").replace(epochs=2, train_size=1000, test_size=300,
                                                 ema_decay=0.5)
    full = api.train(config, str(tmp_path / "full"), verbose=False)
    api.train(config.replace(epochs=1), str(tmp_path / "split"), verbose=False)
    split = api.train(config, str(tmp_path / "split"), verbose=False, resume=True)
    for got, want in zip(split.history, full.history[1:]):
        assert got["epoch"] == want["epoch"]
        for k in ("train_loss", "test_elbo"):
            assert math.isclose(got[k], want[k], rel_tol=REL, abs_tol=0.0), k
    for (name, a), (_, b) in zip(split.state.model.named_parameters(),
                                 full.state.model.named_parameters()):
        assert _rel(a, b) <= REL, name
    assert api.eval_elbo("mnist", workdir=str(tmp_path / "split")) == pytest.approx(
        split.best_test_elbo, rel=REL)


@pytest.mark.gpu
def test_a_state_moved_since_capture_raises(cuda):
    """A graph holds the addresses of the state it captured: a new
    optimizer state (a load) makes the next epoch raise."""
    config = configs.get_config("mnist")
    batches = _batches(config, 3, 100)
    model = configs.build_model(config, seed=0)
    state = create_train_state(model, config.learning_rate)
    runner = make_epoch_runner(model, annealing_steps=10)
    state, _ = runner(state, batches)
    state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    with pytest.raises(RuntimeError, match="moved since the graph was captured"):
        runner(state, batches)


@pytest.mark.gpu
def test_a_step_that_syncs_raises_during_capture(cuda, monkeypatch):
    """A host sync in the captured step raises out of the runner; nothing
    falls back to the eager loop. A capture that fails leaves the
    generators it registered (the default CUDA one always) in capture
    mode, which PyTorch ends only when a capture ends: an empty capture
    after it lets the tests that follow draw from them again."""
    make_eval_step = step_module.make_eval_step

    def syncing(model, objective="mvae"):
        eval_step = make_eval_step(model, objective)

        def step(batch):
            metrics = eval_step(batch)
            float(metrics["loss"])  # waits for the device
            return metrics

        return step

    monkeypatch.setattr(step_module, "make_eval_step", syncing)
    model = configs.build_model("mnist", seed=0)
    stacked = api._padded_split(load_dataset("mnist", "test", n=300), 100, 2, cuda)
    runner = make_eval_runner(model)
    with pytest.raises(RuntimeError):
        runner(stacked)
    with torch.cuda.graph(torch.cuda.CUDAGraph()):
        pass
    torch.randn(3, device=cuda)  # the default generator draws again
