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
import json
import math
import os
import pathlib
import subprocess
import sys

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


def _train(config, graph: bool, batches, epochs: int = 2, annealing_steps: int = 1000,
           lr=None, dtype=torch.float32):
    """``epochs`` runs of an epoch runner over ``batches`` from the seeded
    init at the compute ``dtype``: the state, each epoch's metrics and the
    launch counts. ``lr`` (a rate or a schedule) defaults to the config's
    rate; the state accumulates ``config.accum_steps`` micro-steps an
    update."""
    model = configs.build_model(config, seed=0, dtype=dtype)
    state = create_train_state(model, config.learning_rate if lr is None else lr,
                               grad_clip=config.grad_clip, ema_decay=0.5,
                               accum_steps=config.accum_steps)
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
def test_celeba_graph_epoch_with_random_subsets_equals_eager_to_the_bit(cuda):
    """``celeba`` at full width (4 random subsets, T = 24, clipping at 500;
    K4 and its backward kernel in stage 0) at batch 16: two epochs of 3
    replays against two of the eager loop, on cuDNN's deterministic
    algorithms. The masks and the noise are drawn inside the captured step
    from the registered generator, so every metric, parameter and EMA
    parameter is equal to the bit, and so are the launch counts (K4's
    backward once a step)."""
    config = configs.get_config("celeba")
    torch.backends.cudnn.deterministic = True
    batches = _batches(config, 3, 16)
    graph, eager = _train(config, True, batches), _train(config, False, batches)
    _assert_close_runs(graph, eager)
    for mg, me in zip(graph[1], eager[1]):
        assert all(torch.equal(mg[k], me[k]) for k in me)
    for params in (lambda s: s.model.parameters(), lambda s: s.ema_model.parameters()):
        assert all(torch.equal(a, b) for a, b in zip(params(graph[0]), params(eager[0])))
    assert graph[2] == eager[2] and graph[2]["conv_bwd"] == 6 and graph[2]["conv"] == 6


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["celeba", "cub"])
def test_bf16_graph_epoch_equals_eager_to_the_bit(cuda, name):
    """``celeba`` and ``cub`` at full width with bf16 experts (stage 0 in K4
    at all-bf16, its backward kernel, and on CUB's cycle term its input
    gradient, all at bf16) at batch 16: two epochs of 3 replays against
    two of the eager loop on cuDNN's deterministic algorithms, every
    metric, parameter and EMA parameter and the launch counts equal to the
    bit; the parameters stay f32."""
    config = configs.get_config(name)
    torch.backends.cudnn.deterministic = True
    batches = _batches(config, 3, 16)
    graph, eager = (_train(config, g, batches, dtype=torch.bfloat16) for g in (True, False))
    _assert_close_runs(graph, eager)
    for mg, me in zip(graph[1], eager[1]):
        assert all(torch.equal(mg[k], me[k]) for k in me)
    for params in (lambda s: s.model.parameters(), lambda s: s.ema_model.parameters()):
        assert all(torch.equal(a, b) for a, b in zip(params(graph[0]), params(eager[0])))
    assert all(p.dtype == torch.float32 for p in graph[0].model.parameters())
    assert graph[2] == eager[2]
    per_step = {"celeba": (1, 1, 0), "cub": (2, 2, 1)}[name]
    assert (graph[2]["conv"], graph[2]["conv_bwd"], graph[2]["conv_dx"]) == tuple(
        6 * n for n in per_step)


@pytest.mark.gpu
@pytest.mark.parametrize("objective", ["mopoe", "mvtcae"])
def test_mixture_graph_epoch_equals_eager_to_the_bit(cuda, objective):
    """``mnist`` at full width under mopoe (its 3 powerset components, made
    on the device inside the step) and mvtcae (the joint and unimodal
    rows, the cross-KLs) at batch 100: two epochs of 4 replays against two
    of the eager loop on deterministic algorithms. Every metric (mvtcae's
    ``cross_kl`` with them), parameter and EMA parameter is equal to the
    bit, and so are the launch counts. The capture makes no constant:
    ``_StepGraph`` raises if one is made under it, and the cached
    constants do not grow over the replays."""
    config = configs.get_config("mnist").replace(objective=objective)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        batches = _batches(config, 4, 100)
        graph = _train(config, True, batches)
        constants = step_module._device_tensor.cache_info().currsize
        eager = _train(config, False, batches)
    finally:
        torch.use_deterministic_algorithms(False)
    assert step_module._device_tensor.cache_info().currsize == constants
    _assert_close_runs(graph, eager)
    for mg, me in zip(graph[1], eager[1]):
        assert all(torch.equal(mg[k], me[k]) for k in me)
    assert ("cross_kl" in graph[1][0]) == (objective == "mvtcae")
    for params in (lambda s: s.model.parameters(), lambda s: s.ema_model.parameters()):
        assert all(torch.equal(a, b) for a, b in zip(params(graph[0]), params(eager[0])))
    assert graph[2] == eager[2] and graph[2]["poe_kl"] == graph[2]["bce_bwd"] == 8


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 3])
def test_accumulated_graph_epochs_equal_eager_to_the_bit(cuda, k):
    """``mnist`` at full width with ``accum_steps`` k, clipping at 1, EMA
    and the cosine schedule (its first update at rate 0): two epochs of 5
    micro-steps, so an update straddles the epoch boundary, as replays of
    the two captured bodies (a micro-step, a micro-step that commits)
    against the eager loop. Every metric, parameter, EMA parameter, the
    running mean, Adam's moments and the scheduled rate are equal to the
    bit, and so are the launch counts and the noise generator's state (one
    generator registered with both graphs advances as the eager loop)."""
    from mmvae_torch.train.state import learning_rate

    config = configs.get_config("mnist").replace(
        accum_steps=k, grad_clip=1.0, lr_schedule="cosine", warmup_epochs=1, epochs=4)
    lr = learning_rate(config, 5)
    batches = _batches(config, 5, 100)
    graph, eager = _train(config, True, batches, lr=lr), _train(config, False, batches, lr=lr)
    _assert_close_runs(graph, eager)
    for mg, me in zip(graph[1], eager[1]):
        assert all(torch.equal(mg[key], me[key]) for key in me)
    (s_g, _, launches_g, _), (s_e, _, launches_e, _) = graph, eager
    for params in (lambda s: s.model.parameters(), lambda s: s.ema_model.parameters(),
                   lambda s: s.acc_grads):
        assert all(torch.equal(a, b) for a, b in zip(params(s_g), params(s_e)))
    for p, q in zip(s_g.model.parameters(), s_e.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s_g.optimizer.state[p][key], s_e.optimizer.state[q][key])
    assert int(s_g.optimizer.state[next(s_g.model.parameters())]["step"]) == 10 // k
    lr_g, lr_e = s_g.optimizer.param_groups[0]["lr"], s_e.optimizer.param_groups[0]["lr"]
    last = torch.tensor(10 // k - 1, device="cuda")  # the count of the last update
    assert torch.equal(lr_g, lr_e) and torch.equal(lr_g, lr(last))
    assert s_g.step == 10 and s_g.micro_step == 10 % k
    assert launches_g == launches_e and launches_g["poe_kl"] == launches_g["bce_bwd"] == 10


@pytest.mark.gpu
def test_an_update_at_rate_0_leaves_the_parameters(cuda):
    """The cosine schedule's first update on the card: capturable Adam at
    a rate of exactly 0 leaves every parameter as it was, components of
    gradient 0 (whose moments stay 0) included, and moves the moments."""
    from mmvae_torch.train.state import learning_rate

    config = configs.get_config("mnist").replace(lr_schedule="cosine", epochs=2)
    model = configs.build_model(config, seed=0)
    state = create_train_state(model, learning_rate(config, 10), ema_decay=0.5)
    before = [p.detach().clone() for p in model.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen, device="cuda")
        p.grad.view(-1)[::3] = 0.0
    state.apply_gradients()
    assert state.optimizer.param_groups[0]["lr"].item() == 0.0
    assert all(torch.equal(p, b) for p, b in zip(model.parameters(), before))
    assert all(state.optimizer.state[p]["exp_avg"].abs().max() > 0 for p in model.parameters())
    state.apply_gradients()
    assert state.optimizer.param_groups[0]["lr"].item() > 0
    assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.gpu
def test_an_async_snapshot_is_ordered_against_the_next_replays(cuda, tmp_path):
    """``AsyncCheckpointWriter.stage`` after a graph epoch, then another
    graph epoch at once (its replays update the parameters, the moments and
    the running mean in place on the current stream): the checkpoint holds
    the state as it was at the stage, bit for bit."""
    from mmvae_torch.train.checkpoint import AsyncCheckpointWriter, load_checkpoint

    config = configs.get_config("mnist").replace(accum_steps=3)
    batches = _batches(config, 5, 100)
    model = configs.build_model(config, seed=0)
    state = create_train_state(model, config.learning_rate, ema_decay=0.5, accum_steps=3)
    runner = make_epoch_runner(model, annealing_steps=10,
                               generator=torch.Generator(device="cuda").manual_seed(1))
    state, _ = runner(state, batches)
    want = {name: p.detach().clone() for name, p in model.named_parameters()}
    want_acc = [a.clone() for a in state.acc_grads]
    writer = AsyncCheckpointWriter(str(tmp_path))
    assert writer.stage(state, 1)
    state, _ = runner(state, batches)
    writer.finalize()
    assert writer.saved == 1
    fresh = create_train_state(configs.build_model(config, seed=1), config.learning_rate,
                               ema_decay=0.5, accum_steps=3)
    fresh, extra = load_checkpoint(str(tmp_path), fresh, which="last")
    assert extra["epoch"] == 1 and fresh.step == 5
    for name, p in fresh.model.named_parameters():
        assert torch.equal(p, want[name]), name
    assert all(torch.equal(a, b) for a, b in zip(fresh.acc_grads, want_acc))
    assert not torch.equal(next(model.parameters()), want[next(iter(want))])


@pytest.mark.gpu
def test_ckpt_async_train_equals_the_synchronous_run(cuda, tmp_path):
    """``api.train`` with ``ckpt_async`` on the card: the history and the
    last checkpoint equal the synchronous run's to the bit."""
    config = configs.get_config("mnist").replace(epochs=3, train_size=500, test_size=300,
                                                 accum_steps=2)
    sync = api.train(config, str(tmp_path / "sync"), verbose=False)
    overlapped = api.train(config.replace(ckpt_async=True), str(tmp_path / "async"),
                           verbose=False)
    assert overlapped.history == sync.history
    trees = [torch.load(tmp_path / d / "ckpt" / "last_00003" / "state.pt", weights_only=True)
             for d in ("sync", "async")]
    for name, t in trees[0]["model"].items():
        assert torch.equal(t, trees[1]["model"][name]), name
    assert all(torch.equal(a, b) for a, b in zip(trees[0]["acc_grads"], trees[1]["acc_grads"]))


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

    def syncing(model, *args, **kwargs):
        eval_step = make_eval_step(model, *args, **kwargs)

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



# Run in a process of its own: the first optimizer a process builds makes
# torch import torch._dynamo, and what a call leaves behind then is the
# question (mmvae_torch/train/state.py).
_TWO_TRAIN_CALLS = """
import gc, json, torch
gc.disable()
from mmvae_torch import api, configs
config = configs.get_config("cub").replace(epochs=1, train_size=128, test_size=64)
after = []
for _ in range(2):
    torch.cuda.reset_peak_memory_stats()
    api.train(config, verbose=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_reserved()
    torch.cuda.empty_cache()
    after.append([torch.cuda.memory_allocated(), torch.cuda.memory_reserved(), peak])
gc.set_debug(gc.DEBUG_SAVEALL)
gc.collect()
held = sum(1 for o in gc.garbage if isinstance(o, torch.Tensor) and o.is_cuda)
print(json.dumps({"after": after, "held": held}))
"""


@pytest.mark.gpu
def test_a_finished_train_call_leaves_no_card_memory_behind(cuda):
    """``api.train`` of ``cub`` at full width (its runners' captured graphs
    and their private pools, K4's input gradient in the step), twice in a
    fresh process with the cyclic collector off, gives back what it held
    when it returns: no reference cycle holds a card tensor, the second
    call ends with the memory the first ended with, and what the
    allocator keeps reserved once its cache is emptied grows by less than
    a tenth of a call's peak (a captured graph's pool kept alive would be
    most of it)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _TWO_TRAIN_CALLS], cwd=root, check=True,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(root)})
    result = json.loads(out.stdout.strip().splitlines()[-1])
    (alloc_1, reserved_1, peak_1), (alloc_2, reserved_2, _) = result["after"]
    assert result["held"] == 0
    assert alloc_2 == alloc_1, result
    assert reserved_2 - reserved_1 < peak_1 / 10, result


@pytest.mark.gpu
@pytest.mark.parametrize("name, n_steps, bs", [("deep_mnist", 6, 100), ("deep_cub", 3, 16)])
def test_deep_trunk_graph_epoch_equals_eager_to_the_bit(cuda, name, n_steps, bs):
    """The deep configs at full width, their ReZero gates made live (a
    fresh trunk is the identity): the stage loop captured with the step,
    two epochs of replays against two of the eager loop on deterministic
    algorithms, every metric and parameter to the bit, the gates' updates
    among them, and the launches of the shallow config's step."""
    config = configs.get_config(name)
    torch.backends.cudnn.deterministic = True
    batches = _batches(config, n_steps, bs)
    runs = []
    for graph in (True, False):
        model = configs.build_model(config, seed=0)
        with torch.no_grad():
            for expert in (model.image_enc, model.image_dec):
                expert.trunk.alphas.fill_(0.5)
        state = create_train_state(model, config.learning_rate, grad_clip=config.grad_clip)
        runner = make_epoch_runner(model, graph=graph, annealing_steps=1000,
                                   generator=torch.Generator(device="cuda").manual_seed(5),
                                   **api.step_options(config))
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        per_epoch = [runner(state, batches)[1] for _ in range(2)]
        runs.append((state, per_epoch, dict(kernels.LAUNCHES)))
    (s_g, m_g, l_g), (s_e, m_e, l_e) = runs
    for mg, me in zip(m_g, m_e):
        assert all(torch.equal(mg[k], me[k]) for k in me)
    assert all(torch.equal(a, b) for a, b in zip(s_g.model.parameters(), s_e.model.parameters()))
    assert not torch.equal(s_g.model.image_enc.trunk.alphas,
                           torch.full_like(s_g.model.image_enc.trunk.alphas, 0.5))
    assert l_g == l_e and l_g["poe_kl_bwd"] == 2 * n_steps * (2 if name == "deep_cub" else 1)


@pytest.mark.gpu
def test_a_streamed_grain_epoch_with_a_short_tail_equals_the_whole_one(cuda, tmp_path):
    """``mnist`` on the grain backend, 2 epochs of 7 steps with presence
    dropout: segments of 3 (the last of each epoch 1 step, replayed from
    the 3-step capture's leading row) against the whole epoch: the
    histories and every parameter to the bit, and the stream's hits."""
    config = configs.get_config("mnist").replace(
        epochs=2, train_size=700, test_size=200, data_backend="grain", p_modality_drop=0.3)
    whole = api.train(config, verbose=False)
    streamed = api.train(config.replace(grain_stream_steps=3), str(tmp_path), verbose=False)
    assert streamed.history == whole.history
    assert all(torch.equal(a, b) for a, b in zip(whole.model.parameters(),
                                                  streamed.model.parameters()))
    with open(tmp_path / "metrics.jsonl") as f:
        rates = [r["stream_hit_rate"] for r in map(json.loads, f) if r["kind"] == "eval"]
    assert rates == [2 / 3, 5 / 6]


@pytest.mark.gpu
def test_a_graph_runner_replays_a_shorter_call_on_its_leading_rows(cuda):
    """A call of fewer rows than the capture's replays only those rows: the
    two calls together equal one eager pass over the rows, and a longer call
    raises."""
    config = configs.get_config("mnist")
    batches = _batches(config, 5, 100)
    head, tail = ({k: v[:3] for k, v in batches.items()}, {k: v[3:] for k, v in batches.items()})
    runs = []
    for graph in (True, False):
        model = configs.build_model(config, seed=0)
        state = create_train_state(model, config.learning_rate)
        runner = make_epoch_runner(model, graph=graph, annealing_steps=1000,
                                   generator=torch.Generator(device="cuda").manual_seed(5))
        metrics = [runner(state, part)[1]["loss"] for part in (head, tail)]
        runs.append((torch.cat(metrics), list(model.parameters()), state, runner))
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][0].shape == (5,)
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    with pytest.raises(ValueError, match="or fewer of its rows"):
        runs[0][3](runs[0][2], batches)


@pytest.mark.gpu
@pytest.mark.parametrize("fields", [dict(reshuffle_every=3, shuffle_mode="roll"),
                                    dict(reshuffle_every=3, shuffle_mode="block"),
                                    dict(shuffle_granularity=4)])
def test_each_shuffle_mode_under_the_graph_runner(cuda, fields):
    """4 epochs of ``mnist`` at full width over 600 rows in each shuffle
    mode: the graph runner's epochs equal the eager loop's to the bit (the
    order is drawn on the host, the same rows each way), 4 epochs of steps."""
    config = configs.get_config("mnist").replace(n_latents=64, train_size=600, **fields)
    arrays = {k: torch.as_tensor(v, device="cuda")
              for k, v in load_dataset("mnist", "train", n=600).arrays.items()}
    runs = []
    for graph in (True, False):
        model = configs.build_model(config, seed=0)
        state = create_train_state(model, config.learning_rate)
        runner = step_module.make_gather_epoch_runner(
            model, 6, 100, reshuffle_every=config.reshuffle_every,
            shuffle_mode=config.shuffle_mode, shuffle_granularity=config.shuffle_granularity,
            order=torch.Generator().manual_seed(0), graph=graph, annealing_steps=1000,
            generator=torch.Generator(device="cuda").manual_seed(5))
        pos, losses = None, []
        for epoch in range(4):
            state, pos, metrics = runner(state, arrays, pos, epoch == 0)
            losses.append(metrics["loss"])
        runs.append((torch.cat(losses), list(model.parameters()), state.step))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert runs[0][2] == runs[1][2] == 24
