"""What ``tests/test_torch_fsdp.py``, ``tests/test_torch_tp.py`` and
``tests/test_torch_pp.py`` share:
the JAX package's single-device steps that the port's sharded steps are
held to, the element ids that compare a layout with JAX's leaf by leaf,
and the gloo worlds of ``tests/torch_dp_worker.py`` ranks whose results
they check. :func:`worlds` runs all of it once a run: the worlds are
started as soon as JAX's inputs are there and run while the JAX steps
compile; under pytest-xdist the first file to ask takes a lock, runs them
and saves the results beside the workers' temporary directories, and the
other file loads them.

The JAX steps are ``_train_step_impl``'s (``mmvae_tpu/train/step.py``)
under the ``"b"`` fold from a seeded init (MNIST at n_latents 8; CelebA at
n_latents 8 over 16x16 images with conv features (32, 8), so that stage 0
keeps K4's 32 channels and its banks their 18 attributes; for pipeline
parallelism ``deep_mnist`` with a trunk of 2 stages 32 wide and ``deep_cub``
over 16x16 images with conv features (32, 8), 2-stage trunks and captions of
8 tokens), with clipping at
``GRAD_CLIP`` (it fires) and an EMA shadow, spelled out as that step takes
it: the rng split in three, beta of the step count, ``jax.value_and_grad``
of the JAX loss (one jit a model, the steps' only compile), then
``TrainState.apply_gradients``. Each step's noise ``normal(split(rng)[1],
(B, T, L))`` is kept for the port, and the first step's gradient.
"""

from __future__ import annotations

import fcntl
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import optax

from mmvae_tpu.configs import build_model as j_build_model
from mmvae_tpu.configs import get_config as j_get_config
from mmvae_tpu.core import annealing_factor
from mmvae_tpu.data import load_dataset as j_load_dataset
from mmvae_tpu.models import CelebAMVAE as JCelebAMVAE
from mmvae_tpu.models import DeepCubMVAE as JDeepCubMVAE
from mmvae_tpu.models import DeepMnistMVAE as JDeepMnistMVAE
from mmvae_tpu.models import MnistMVAE as JMnistMVAE
from mmvae_tpu.train import step as jstep
from mmvae_tpu.train.state import create_train_state as j_create_train_state
from mmvae_torch import configs, models
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import make_celeba, make_cub, make_mnist

REPO = Path(__file__).resolve().parent.parent
N_LATENTS, B, STEPS, ANNEALING = 8, 8, 3, 10
GRAD_CLIP, EMA_DECAY = 60.0, 0.9
CELEBA = dict(image_hw=(16, 16), conv_features=(32, 8))
RTOL, STEP_REL = 2e-4, 1e-4
# The reference's programs are tiny and run 3 times: XLA's backend at its
# lowest optimization level compiles them in about half the time.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
# name -> (the JAX class, the port's class name, its kwargs, the data, the
# terms T = 1 + M of a step)
MODELS = {
    "mnist": (JMnistMVAE, "MnistMVAE", {}, lambda n: make_mnist(n, seed=5), 3),
    "celeba": (JCelebAMVAE, "CelebAMVAE", CELEBA, lambda n: make_celeba(n, seed=5, hw=16), 20),
}
# The trunk models the pipelined steps take, as MODELS; 2 microbatches.
PP_MODELS = {
    "deep_mnist": (JDeepMnistMVAE, "DeepMnistMVAE",
                   dict(trunk_stages=2, trunk_width=32, pp_n_micro=2),
                   lambda n: make_mnist(n, seed=5), 3),
    "deep_cub": (JDeepCubMVAE, "DeepCubMVAE",
                 dict(image_hw=(16, 16), conv_features=(32, 8), vocab_size=23, max_len=8,
                      trunk_stages=2, pp_n_micro=2),
                 lambda n: make_cub(n, seed=5, hw=16, max_len=8), 3),
}
ALL_MODELS = {**MODELS, **PP_MODELS}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_inputs(names=tuple(ALL_MODELS)) -> dict:
    """Each model's JAX init, batches and the noise of its 3 steps (the rng
    chain does not depend on the parameters), and the state to step from:
    what the port's ranks need, before the JAX steps compile."""
    runs = {}
    for name in names:
        jcls, _, kwargs, make, t = ALL_MODELS[name]
        jm = jcls(n_latents=N_LATENTS, **kwargs)
        data = make(STEPS * B)
        batches = [{k: v[i * B:(i + 1) * B] for k, v in data.items()} for i in range(STEPS)]
        # Jitted: an eager Flax init and optax update compile op by op.
        state = jax.jit(lambda b: j_create_train_state(
            jm, b, jax.random.key(7), 1e-3, grad_clip=GRAD_CLIP, ema_decay=EMA_DECAY),
            compiler_options=FAST_COMPILE)({k: jnp.asarray(v) for k, v in batches[0].items()})
        eps, key = [], state.rng
        for _ in batches:
            rng, _, key = jax.random.split(key, 3)
            eps.append(np.asarray(jax.random.normal(jax.random.split(rng)[1], (B, t, N_LATENTS))))
        runs[name] = {"model": jm, "state": state, "init": _np(state.params),
                      "batches": batches, "eps": np.stack(eps)}
    return runs


def jax_steps(runs: dict) -> dict:
    """The 3 JAX steps of each model of :func:`jax_inputs`: its metrics, the
    parameters and EMA shadow after, and the first step's gradient, added to
    its entry."""
    for run in runs.values():
        jm, state = run["model"], run["state"]
        value_and_grad = jax.value_and_grad(
            lambda q, b, rng, beta: jstep.multi_term_loss(jm, q, b, rng, beta, sample=True,
                                                          term_fold="b"), has_aux=True)

        @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
        def loss_and_grad(q, b, rng, beta):
            (_, m), g = value_and_grad(q, b, rng, beta)
            return m["loss"], g, optax.global_norm(g)

        apply = jax.jit(lambda st, g, r: st.apply_gradients(g, r), compiler_options=FAST_COMPILE)
        metrics, first_grads = [], None
        for batch in run["batches"]:
            rng, _, new_rng = jax.random.split(state.rng, 3)
            beta = annealing_factor(state.step, ANNEALING)
            loss, grads, norm = loss_and_grad(
                state.params, {k: jnp.asarray(v) for k, v in batch.items()}, rng, beta)
            first_grads = first_grads or _np(grads)
            state = apply(state, grads, new_rng)
            metrics.append({"loss": float(loss), "beta": float(beta), "grad_norm": float(norm)})
        run.update(metrics=metrics, params=_np(state.params), ema=_np(state.ema_params),
                   grads=first_grads)
    return runs


# The ``api.train`` runs at world 2: two epochs of MNIST at small widths
# (of deep_mnist with PP_MODELS' trunk under pipeline parallelism).
TRAIN = dict(n_latents=N_LATENTS, epochs=2, train_size=32, test_size=18, batch_size=8,
             grad_clip=GRAD_CLIP, ema_decay=EMA_DECAY)
PP_TRAIN = dict(TRAIN, pp=2, model_kwargs=dict(trunk_stages=2, trunk_width=32, pp_n_micro=2))
_WORLDS: dict = {}


def worlds(tmp_path_factory) -> dict:
    """JAX's steps of every model (``"jax"``) and the ranks' results: two
    ranks that take, one after the other, FSDP over MNIST and CelebA
    (``"fsdp"``: their steps and ``api.train(fsdp=True)``), TP as one model
    group (``"tp"``: the steps, the experts' forwards and
    ``api.train(tp=2)``) and PP as one pipe group (``"pp"``: the trunk
    models' steps, the schedule at pipe 2 and ``api.train(pp=2)``); four
    ranks as data 2 x model 2 (``"tp4"``: MNIST's steps) and for PP
    (``"pp4"``: the schedule at pipe 4 and at data 2 x pipe 2, and
    deep_mnist's steps at data 2 x pipe 2). ``"dirs"`` holds each kind's
    directory (its workdirs). Run once a run (see the module
    docstring)."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if uid is None:
        if not _WORLDS:
            _WORLDS.update(_run_worlds(tmp_path_factory.mktemp("sharded")))
        return _WORLDS
    root = tmp_path_factory.getbasetemp().parent / f"sharded_{uid}"
    root.mkdir(exist_ok=True)
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        saved = root / "worlds.pt"
        if saved.exists():
            return torch.load(saved, weights_only=False)
        out = _run_worlds(root)
        torch.save(out, root / "worlds.tmp")
        os.replace(root / "worlds.tmp", saved)
        return out


def _run_worlds(root: Path) -> dict:
    runs = jax_inputs()
    models = worker_models(runs)
    pp_models = {k: models.pop(k) for k in PP_MODELS}
    common = {"annealing_steps": ANNEALING, "grad_clip": GRAD_CLIP, "ema_decay": EMA_DECAY}
    mnist = configs.get_config("mnist")
    dirs = {k: root / k for k in ("fsdp", "tp", "pp", "two", "four")}
    for d in dirs.values():
        d.mkdir()
    two = start({"models": models, **common, "kinds": {
        "fsdp": {"train_config": mnist.replace(**TRAIN, fsdp=True), "root": str(dirs["fsdp"])},
        "tp": {"tp": 2, "train_config": mnist.replace(**TRAIN, tp=2), "root": str(dirs["tp"])},
        "pp": {"pp": 2, "models": pp_models, "apply": [2], "root": str(dirs["pp"]),
               "train_config": configs.get_config("deep_mnist").replace(**PP_TRAIN)},
    }}, dirs["two"], 2)
    four = start({"models": {"mnist": models["mnist"]}, **common, "kinds": {
        "tp": {"tp": 2},
        "pp": {"pp": 2, "models": {"deep_mnist": pp_models["deep_mnist"]}, "apply": [4, 2]},
    }}, dirs["four"], 4)
    jax_steps(runs)
    for run in runs.values():
        del run["model"], run["state"]
    two, four = finish(two), finish(four)
    return {"jax": runs, "fsdp": [o["fsdp"] for o in two], "tp": [o["tp"] for o in two],
            "pp": [o["pp"] for o in two], "tp4": [o["tp"] for o in four],
            "pp4": [o["pp"] for o in four],
            "dirs": {k: str(dirs[k]) for k in ("fsdp", "tp", "pp")}}


def worker_models(runs: dict) -> dict:
    """The models part of a worker's spec: each model's class, kwargs, the
    converted init, the stacked batches and JAX's noise (of
    :func:`jax_inputs`)."""
    return {name: {"cls": ALL_MODELS[name][1],
                   "kwargs": {"n_latents": N_LATENTS, **ALL_MODELS[name][2]},
                   "init": from_flax_params(run["init"]),
                   "batches": {k: torch.from_numpy(np.stack([b[k] for b in run["batches"]]))
                               for k in run["batches"][0]},
                   "eps": torch.from_numpy(run["eps"])}
            for name, run in runs.items()}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start(spec: dict, tmp: Path, world: int) -> tuple:
    """``world`` ranks of ``tests/torch_dp_worker.py`` on ``spec`` over gloo
    (rank 0 from torchrun's variables, the others from JAX's ``MMVAE_*``
    trio), started; :func:`finish` waits for them."""
    spec_path = tmp / "spec.pt"
    torch.save(spec, spec_path)
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
            and not k.startswith("MMVAE_")}
    envs = [{**base, "RANK": "0", "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
             "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}]
    envs += [{**base, "MMVAE_COORDINATOR": f"localhost:{port}",
              "MMVAE_NUM_PROCESSES": str(world), "MMVAE_PROCESS_ID": str(r)}
             for r in range(1, world)]
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_dp_worker.py"), str(spec_path),
         str(tmp / f"out{r}.pt")], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r, env in enumerate(envs)]
    return procs, tmp


def finish(started: tuple) -> list[dict]:
    """Each rank's results of :func:`start`'s world; a rank that fails
    fails the caller, and every rank is stopped."""
    procs, tmp = started
    try:
        for r, proc in enumerate(procs):
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, f"rank {r}:\n{err[-4000:]}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(len(procs))]


def check_steps(run: dict, got: dict) -> None:
    """A port's 3 sharded steps against the JAX steps: the loss, beta and the
    gradient norm each step at rtol 2e-4, the first step's whole gradient
    (rtol 2e-4, atol 2e-4 of its largest element), the parameters and the
    EMA shadow after by the relative 2-norm of the two updates' difference
    (below 1e-4), as ``tests/test_torch_dp.py`` holds them."""
    for i, m in enumerate(run["metrics"]):
        np.testing.assert_allclose(got["loss"][i].item(), m["loss"], rtol=RTOL)
        np.testing.assert_allclose(got["grad_norm"][i].item(), m["grad_norm"], rtol=RTOL)
        assert got["beta"][i].item() == float(m["beta"])
    for k, v in from_flax_params(run["grads"]).items():
        np.testing.assert_allclose(got["grads"][k].numpy(), v.numpy(), rtol=RTOL,
                                   atol=2e-4 * v.abs().max().item(), err_msg=k)
    init = from_flax_params(run["init"])
    for key in ("params", "ema"):
        want = from_flax_params(run[key])
        diff = sum(((got[key][k] - v) ** 2).sum() for k, v in want.items())
        update = sum(((v - init[k]) ** 2).sum() for k, v in want.items())
        assert update > 0 and (diff / update).sqrt() < STEP_REL, key


def flax_shapes(name: str) -> dict:
    """The Flax parameter tree of config ``name`` at full size, as shapes
    (``jax.eval_shape`` of the init: nothing compiles)."""
    cfg = j_get_config(name)
    model = j_build_model(cfg)
    batch = {k: jnp.asarray(v) for k, v in
             j_load_dataset(cfg.dataset, "train", n=2).arrays.items()}
    key = jax.random.key(0)
    return jax.eval_shape(lambda: model.init(key, batch, rng=key, sample=True))["params"]


def port_model(name: str):
    """Config ``name``'s port model with its parameters on the meta device:
    their shapes alone, which a layout reads (no init)."""
    cfg = configs.get_config(name)
    kwargs = dict(cfg.model_kwargs)
    if cfg.dataset == "cub":
        kwargs["vocab_size"] = configs.cub_vocab_size()
    cls = {"mnist": models.MnistMVAE, "celeba": models.CelebAMVAE, "cub": models.CubMVAE,
           "deep_mnist": models.DeepMnistMVAE, "deep_cub": models.DeepCubMVAE}[name]
    with torch.device("meta"):
        return cls(n_latents=cfg.n_latents, **kwargs)


def element_ids(tree: dict) -> tuple[dict, dict]:
    """A Flax tree of the same shapes whose elements are distinct ids (a
    float32 count, exact below 2**24), and its ids converted to the port's
    ``state_dict``: a layout's block of a port tensor holds the ids of the
    Flax elements it holds."""
    at, ids = 0, {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        n = int(np.prod(leaf.shape))
        ids[path] = np.arange(at, at + n, dtype=np.float32).reshape(leaf.shape)
        at += n
    assert at < 2**24
    flax_ids = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tree),
                                            list(ids.values()))
    return flax_ids, from_flax_params(flax_ids)


def same_blocks(tree: dict, jax_dim, port_dims: dict, n: int) -> int:
    """Assert that a port layout (``port_dims``: name -> dim or None) gives
    every one of ``n`` ranks the elements JAX's gives it (``jax_dim(path,
    leaf)``: the dim of a Flax leaf sharded over the axis, or None), leaf by
    leaf: each element's owner under JAX's blocks, looked up at the ids of
    each port block; returns the leaves sharded."""
    flax_ids, port_ids = element_ids(tree)
    leaves = jax.tree_util.tree_flatten_with_path(flax_ids)[0]
    by_start = {int(leaf.ravel()[0]): (path, leaf) for path, leaf in leaves}
    owner = np.full(sum(leaf.size for _, leaf in leaves), -1, dtype=np.int8)
    assert set(port_dims) == set(port_ids)
    sharded = 0
    for name, t in port_ids.items():
        path, leaf = by_start[int(t.min())]
        jd, pd = jax_dim(path, leaf), port_dims[name]
        assert (jd is None) == (pd is None), (name, path, jd, pd)
        if jd is None:
            continue
        sharded += 1
        for r, jb in enumerate(np.split(leaf, n, axis=jd)):
            owner[jb.ravel().astype(np.int64)] = r
        for r, pb in enumerate(torch.chunk(t, n, dim=pd)):
            ids = pb.numpy().ravel().astype(np.int64)
            assert ids.size == leaf.size // n and (owner[ids] == r).all(), (name, path, r)
    return sharded
