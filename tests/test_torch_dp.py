"""Data parallelism of the port against the JAX package, on the CPU.

Two processes (``tests/torch_dp_worker.py``, which imports no JAX) join a
gloo group, rank 0 from torchrun's variables and rank 1 from JAX's
``MMVAE_*`` trio, and run every scenario once for the module (a
module-scoped fixture: one launch). The JAX side runs here, its mesh two
of the conftest's 8 fake CPU devices (``make_mesh(jax.devices()[:2])``):

  * 3 steps of ``_train_step_impl`` on that mesh under the ``"st"`` and
    ``"b"`` folds from a seeded MNIST init, against the port's steps at 2
    ranks, each rank given its rows of each batch and of JAX's noise
    (``normal(split(split(state.rng, 3)[0])[1], (B, T, L))``): the loss and
    the gradient norm each step at rtol 2e-4 (XLA-CPU transcendentals are
    approximate, docs/DESIGN.md section 7), the parameters after by the
    relative 2-norm of the two updates' difference (below 1e-4), as
    ``tests/test_torch_train.py`` holds them, the first step's all-reduced
    gradient against ``jax.value_and_grad`` of the JAX loss on the mesh
    (each tensor at rtol 2e-4, atol 2e-4 of its largest element), and both
    ranks' parameters and gradients equal to the bit;
  * ``eval_elbo(mesh=)`` and ``log_likelihood(mesh=)`` of a 37-example
    split at batch 9 (rounded up to 10 over the ranks) against the same
    process alone, at rel 1e-5;
  * ``api.train`` at world 2: rank 1's workdir never written, and one
    epoch resumed for a second equal to two uninterrupted epochs.

``epoch_order(n_shards=2)`` is held here, in one process, against the JAX
gather runner's per-shard orders (``step.py:1339-1450``) with its draws
passed in, as ``tests/test_torch_shuffle.py`` holds the one-shard orders.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from mmvae_tpu.models import MnistMVAE as JMnistMVAE
from mmvae_tpu.parallel import make_mesh as j_make_mesh
from mmvae_tpu.parallel import replicate as j_replicate
from mmvae_tpu.parallel import shard_batch as j_shard_batch
from mmvae_tpu.train import step as jstep
from mmvae_tpu.train.state import create_train_state as j_create_train_state
from mmvae_torch import configs
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import make_mnist
from mmvae_torch.parallel import multihost
from mmvae_torch.train import epoch_order, step as tstep

REPO = Path(__file__).resolve().parent.parent
N_LATENTS, B, M = 8, 8, 2
T = 1 + M
STEPS, ANNEALING = 3, 10
RTOL, STEP_REL = 2e-4, 1e-4
FOLDS = ("st", "b")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's init, batches, its 3 steps on a 2-device mesh under each fold
    and each step's noise."""
    jm = JMnistMVAE(n_latents=N_LATENTS)
    data = make_mnist(STEPS * B, seed=5)
    batches = [{k: v[i * B:(i + 1) * B] for k, v in data.items()} for i in range(STEPS)]
    mesh = j_make_mesh(jax.devices()[:2])
    runs = {}
    for fold in FOLDS:
        state = j_create_train_state(jm, {k: jnp.asarray(v) for k, v in batches[0].items()},
                                     jax.random.key(7), 1e-3)
        init = _np_tree(state.params)
        step = jax.jit(jstep._train_step_impl(
            jm, n_random_subsets=0, annealing_steps=ANNEALING, p_modality_drop=0.0,
            mesh=mesh, term_fold=fold))
        state = j_replicate(state, mesh)
        rng = jax.random.split(state.rng, 3)[0]
        sharded = j_shard_batch({k: jnp.asarray(v) for k, v in batches[0].items()}, mesh)
        _, grads = jax.jit(jax.value_and_grad(
            lambda q: jstep.multi_term_loss(jm, q, sharded, rng, 0.0, sample=True, mesh=mesh,
                                            term_fold=fold), has_aux=True))(state.params)
        metrics, eps = [], []
        for batch in batches:
            rng_z = jax.random.split(jax.random.split(state.rng, 3)[0])[1]
            eps.append(np.asarray(jax.random.normal(rng_z, (B, T, N_LATENTS))))
            state, m = step(state, j_shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                                                 mesh))
            metrics.append(_np_tree(m))
        runs[fold] = {"init": init, "params": _np_tree(state.params), "metrics": metrics,
                      "eps": np.stack(eps), "grads": _np_tree(grads)}
    return batches, runs


@pytest.fixture(scope="module")
def ranks(jax_runs, tmp_path_factory):
    """Both ranks' results of every scenario, from one launch."""
    batches, runs = jax_runs
    tmp = tmp_path_factory.mktemp("dp")
    init = from_flax_params(runs["st"]["init"])
    split = make_mnist(37, seed=9)
    spec = {
        "n_latents": N_LATENTS, "annealing_steps": ANNEALING, "init": init,
        "batches": {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]},
        "eps": {fold: torch.from_numpy(runs[fold]["eps"]) for fold in FOLDS},
        "eval_split": {k: torch.from_numpy(v) for k, v in split.items()}, "eval_batch": 9,
        "train_config": configs.get_config("mnist").replace(
            n_latents=N_LATENTS, epochs=2, train_size=32, test_size=18, batch_size=8),
        "root": str(tmp),
    }
    spec_path = tmp / "spec.pt"
    torch.save(spec, spec_path)
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
            and not k.startswith("MMVAE_")}
    envs = [
        {**base, "RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
         "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)},
        {**base, "MMVAE_COORDINATOR": f"localhost:{port}", "MMVAE_NUM_PROCESSES": "2",
         "MMVAE_PROCESS_ID": "1"},
    ]
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_dp_worker.py"), str(spec_path),
         str(tmp / f"out{r}.pt")], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r, env in enumerate(envs)]
    try:
        for r, proc in enumerate(procs):
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, f"rank {r}:\n{err[-4000:]}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(2)], tmp


def test_the_ranks_form_one_group_from_both_env_conventions(ranks):
    out, _ = ranks
    assert [o["rank"] for o in out] == [0, 1]
    assert [o["env"] for o in out] == ["torchrun", "mmvae"]
    assert all(o["size"] == 2 and o["backend"] == "gloo" and o["axis_names"] == ("data",)
               for o in out)


def test_the_mesh_places_batches_and_state_as_jax_does(ranks):
    """On the mesh's ``DeviceMesh``: ``batch_sharding`` gives each rank the
    rows ``shard_batch`` gives it (JAX's ``P("data")`` shard) and
    ``replicated_sharding`` the whole batch (``P()``); ``replicate`` makes
    every rank's tensor rank 0's; ``fetch_replicated`` is the identity; a
    2-slice mesh is ``("dcn", "data")`` of shape (2, 1)."""
    out, _ = ranks
    for r, o in enumerate(out):
        p = o["placements"]
        assert torch.equal(p["sharded"], p["rows"])
        assert torch.equal(p["rows"], p["whole"][r * B // 2:(r + 1) * B // 2])
        assert torch.equal(p["replicated"], p["whole"])
        assert torch.equal(p["broadcast"], torch.zeros(3))
        assert p["fetch_is_identity"]
        assert p["two_slices"] == (("dcn", "data"), {"dcn": 2, "data": 1}, ("dcn", "data"),
                                   (2, 1))


@pytest.mark.parametrize("fold", FOLDS)
def test_dp_steps_match_the_jax_mesh_step(jax_runs, ranks, fold):
    """3 steps at 2 ranks under ``fold`` against the JAX step on a
    2-device mesh: loss, beta and gradient norm each step, the first
    step's all-reduced gradient, the parameters after, and the two ranks'
    parameters and gradients equal to the bit."""
    _, runs = jax_runs
    out, _ = ranks
    want = runs[fold]
    got = out[0]["steps"][fold]
    for i, m in enumerate(want["metrics"]):
        np.testing.assert_allclose(got["loss"][i].item(), m["loss"], rtol=RTOL)
        np.testing.assert_allclose(got["grad_norm"][i].item(), m["grad_norm"], rtol=RTOL)
        assert got["beta"][i].item() == pytest.approx(float(m["beta"]), abs=0)
    w, init = from_flax_params(want["params"]), from_flax_params(want["init"])
    assert set(got["params"]) >= set(w)
    diff = sum(((got["params"][k] - v) ** 2).sum() for k, v in w.items())
    update = sum(((v - init[k]) ** 2).sum() for k, v in w.items())
    assert update > 0 and (diff / update).sqrt() < STEP_REL
    for k in w:
        assert torch.equal(out[1]["steps"][fold]["params"][k], got["params"][k])
    for k, v in from_flax_params(want["grads"]).items():
        np.testing.assert_allclose(got["grads"][k].numpy(), v.numpy(), rtol=RTOL,
                                   atol=2e-4 * v.abs().max().item(), err_msg=k)
        assert torch.equal(out[1]["steps"][fold]["grads"][k], got["grads"][k])


def test_mesh_eval_and_iwae_match_one_process(ranks):
    """A 37-example split at batch 9, rounded up to 10 over 2 ranks with the
    pad rows masked: ``eval_elbo`` and ``log_likelihood`` with the mesh
    against the same process alone (its own batch of 9) at rel 1e-5, and
    the same value on both ranks."""
    out, _ = ranks
    for o in out:
        ev = o["evals"]
        assert ev["elbo_mesh"] == pytest.approx(ev["elbo_alone"], rel=1e-5)
        assert ev["ll_mesh"] == pytest.approx(ev["ll_alone"], rel=1e-5)
    assert out[0]["evals"]["elbo_mesh"] == out[1]["evals"]["elbo_mesh"]
    assert out[0]["evals"]["ll_mesh"] == out[1]["evals"]["ll_mesh"]


def test_rank_zero_alone_writes_and_a_resume_continues(ranks):
    """``api.train`` at world 2 into a workdir of each rank's own: rank 0's
    holds the config, the metrics and the checkpoint, rank 1's does not
    exist; both ranks end on the same parameters and history. One epoch
    into a shared workdir, resumed (every rank reading rank 0's
    checkpoint) for the second, gives the two uninterrupted epochs'
    second record."""
    out, tmp = ranks
    assert not (tmp / "own_1").exists()
    written = {p.name for p in (tmp / "own_0").iterdir()}
    assert {"config.json", "metrics.jsonl", "ckpt"} <= written
    a, b = (o["workdirs"] for o in out)
    assert a["whole"] == b["whole"] and len(a["whole"]) == 2
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    for o in (a, b):
        (resumed,) = o["resumed"]
        whole = o["whole"][1]
        assert resumed["epoch"] == whole["epoch"] == 2
        for k in ("train_loss", "test_elbo"):
            assert resumed[k] == pytest.approx(whole[k], rel=1e-6)


@struct.dataclass
class _State:
    step: jax.Array
    rng: jax.Array


SIZE, BS, SHARDS = 60, 8, 2
N_STEPS = SIZE // BS
PER = SIZE // SHARDS


def _recording_impl(model, **kw):
    def impl(state, batch):
        return state.replace(step=state.step + 1,
                             rng=jax.random.split(state.rng, 3)[2]), {"rows": batch["rows"]}
    return impl


@pytest.mark.parametrize("mode,reshuffle_every,gran", [
    ("roll", 1, 1), ("roll", 3, 1), ("block", 3, 1), ("roll", 3, 5), ("block", 3, 5),
    ("roll", 1, 7)])
def test_sharded_epoch_order_matches_jax(monkeypatch, mode, reshuffle_every, gran):
    """``epoch_order(n_shards=2)`` against the JAX gather runner at
    ``n_shards=2`` (its step body replaced by one that records its batch,
    as ``tests/test_torch_shuffle.py`` does): every step of four epochs
    reads the same rows, with JAX's draws of each epoch passed in (the
    per-shard orders of ``split(shuffle_rng, 2)``, the shared group
    offset, roll offset and block order); groups of 5 divide a shard of 30
    rows, 7 does not (exact rows)."""
    monkeypatch.setattr(jstep, "_train_step_impl", _recording_impl)
    run = jstep.make_gather_epoch_runner(None, N_STEPS, BS, reshuffle_every=reshuffle_every,
                                         shuffle_mode=mode, shuffle_granularity=gran,
                                         n_shards=SHARDS, term_fold="b")
    state = _State(step=jnp.int32(0), rng=jax.random.key(11))
    arrays = {"rows": jnp.arange(SIZE, dtype=jnp.int32)}
    g = gran if PER % gran == 0 else 1
    pos = torch.arange(SIZE)
    for e in range(4):
        shuffle_rng, roll_rng, off_rng, _ = jax.random.split(state.rng, 4)
        draws = {
            "order": np.stack([np.asarray(jax.random.permutation(k, PER // g))
                               for k in jax.random.split(shuffle_rng, SHARDS)]),
            "group_offset": int(jax.random.randint(off_rng, (), 0, g)),
            "roll_offset": int(jax.random.randint(roll_rng, (), 1, PER)),
            "block_order": np.asarray(jax.random.permutation(roll_rng, N_STEPS)),
        }
        state, arrays, ms = run(state, arrays, e == 0)
        pos, rows = epoch_order(pos, e, N_STEPS, BS, reshuffle_every=reshuffle_every,
                                shuffle_mode=mode, shuffle_granularity=gran,
                                force_shuffle=e == 0, draws=draws, n_shards=SHARDS)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(ms["rows"]), err_msg=f"epoch {e}")


def test_sharded_order_keeps_each_shard_and_the_fold_follows_jax():
    """With the port's own draws every row stays in its shard and each batch
    takes BS / 2 rows of each; the gather runner's fold is JAX's choice:
    ``"b"`` with only ``n_shards``, ``"t"`` at one shard; a size that does
    not divide over the shards raises."""
    gen = torch.Generator().manual_seed(0)
    pos, rows = epoch_order(torch.arange(SIZE), 0, N_STEPS, BS, generator=gen, n_shards=SHARDS)
    assert torch.equal(pos[:PER].sort().values, torch.arange(PER))
    assert bool((rows[:, :BS // 2] < PER).all() and (rows[:, BS // 2:] >= PER).all())
    seen = {}

    def fake_runner(model, graph=None, **kw):
        seen.update(kw)
        return None

    for n_shards, fold in ((2, "b"), (1, "t")):
        orig = tstep.make_epoch_runner
        tstep.make_epoch_runner = fake_runner
        try:
            tstep.make_gather_epoch_runner(None, N_STEPS, BS, n_shards=n_shards)
        finally:
            tstep.make_epoch_runner = orig
        assert seen["term_fold"] == fold and seen["mesh"] is None
    with pytest.raises(ValueError, match="divide over 2 shards"):
        epoch_order(torch.arange(SIZE - 1), 0, N_STEPS, BS, generator=gen, n_shards=SHARDS)


def test_initialize_raises_without_a_group_to_form(monkeypatch):
    """No address, size or rank in the arguments or the environment: the
    group cannot form and ``initialize`` raises; nothing runs alone."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "MMVAE_COORDINATOR",
              "MMVAE_NUM_PROCESSES", "MMVAE_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no coordinator address"):
        multihost.initialize()
    assert multihost.process_count() == 1 and multihost.is_primary()
