"""One rank of ``tests/test_torch_dp.py``'s two-rank gloo runs on the CPU.

    python tests/torch_dp_worker.py SPEC OUT

joins the process group from its environment (``parallel.multihost
.initialize``: the test gives rank 0 torchrun's variables and rank 1 JAX's
``MMVAE_*`` trio) and runs every scenario of ``SPEC`` (a ``torch.save``
dict the test writes), saving what it got to ``OUT``. It imports nothing
of JAX: the test holds the results against the JAX package.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mmvae_torch import api, configs  # noqa: E402
from mmvae_torch.data import Dataset  # noqa: E402
from mmvae_torch.models import MnistMVAE  # noqa: E402
from mmvae_torch.parallel import (  # noqa: E402
    batch_sharding,
    make_mesh,
    multihost,
    replicate,
    replicated_sharding,
    shard_batch,
)
from mmvae_torch.train import (  # noqa: E402
    create_train_state,
    make_epoch_runner,
    make_train_step,
)


def dp_steps(spec: dict, mesh) -> dict:
    """The JAX test's DP steps under each fold: this rank's rows of every
    batch and of JAX's noise, from JAX's init; and the first step's
    gradient after its all-reduce."""
    out = {}
    for fold, eps in spec["eps"].items():
        local = shard_batch({**spec["batches"], "eps": eps}, mesh, dim=1)
        model = MnistMVAE(n_latents=spec["n_latents"])
        model.load_state_dict(spec["init"])
        step = make_train_step(model, annealing_steps=spec["annealing_steps"], term_fold=fold,
                               mesh=mesh)
        step(create_train_state(model, 1e-3), {k: v[0] for k, v in local.items() if k != "eps"},
             eps=local["eps"][0])
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        model = MnistMVAE(n_latents=spec["n_latents"])
        model.load_state_dict(spec["init"])
        state = create_train_state(model, 1e-3)
        runner = make_epoch_runner(model, annealing_steps=spec["annealing_steps"],
                                   term_fold=fold, mesh=mesh)
        state, metrics = runner(state, local)
        out[fold] = {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
                     "beta": metrics["beta"], "grads": grads,
                     "params": dict(model.state_dict())}
    return out


def evals(spec: dict, mesh) -> dict:
    """``eval_elbo`` and ``log_likelihood`` of a split that does not divide
    over the ranks, with the mesh and without it (this process alone)."""
    cfg = configs.get_config("mnist").replace(n_latents=spec["n_latents"])
    model = MnistMVAE(n_latents=spec["n_latents"])
    model.load_state_dict(spec["init"])
    data = Dataset(spec["eval_split"], len(next(iter(spec["eval_split"].values()))))
    kw = dict(model=model, dataset=data, batch_size=spec["eval_batch"], device="cpu")
    return {
        "elbo_mesh": api.eval_elbo(cfg, mesh=mesh, **kw),
        "elbo_alone": api.eval_elbo(cfg, **kw),
        "ll_mesh": api.log_likelihood(cfg, k=4, seed=3, mesh=mesh, **kw),
        "ll_alone": api.log_likelihood(cfg, k=4, seed=3, **kw),
    }


def placements(spec: dict, mesh) -> dict:
    """The mesh's placements: a batch distributed on ``mesh.device_mesh``
    with ``batch_sharding`` (this rank's local shard) and with
    ``replicated_sharding`` (the whole), the ``shard_batch`` rows of it,
    a tensor of this rank's index after ``replicate``, whether
    ``fetch_replicated`` is the identity, and a 2-slice mesh's axes."""
    from torch.distributed.tensor import distribute_tensor

    x = spec["batches"]["image"][0]
    mine = torch.full((3,), float(mesh.rank))
    two = make_mesh(n_slices=2)
    return {
        "sharded": distribute_tensor(x, mesh.device_mesh, batch_sharding(mesh)).to_local(),
        "replicated": distribute_tensor(x, mesh.device_mesh,
                                        replicated_sharding(mesh)).to_local(),
        "rows": shard_batch({"x": x}, mesh)["x"], "whole": x,
        "broadcast": replicate([mine], mesh)[0],
        "fetch_is_identity": multihost.fetch_replicated(spec) is spec,
        "two_slices": (two.axis_names, two.shape, two.device_mesh.mesh_dim_names,
                       tuple(two.device_mesh.shape)),
    }


def workdirs(spec: dict, rank: int) -> dict:
    """``api.train`` at world 2: two epochs into a workdir of this rank's
    own (only rank 0's may be written), then one epoch into a shared
    workdir resumed for the second."""
    cfg = spec["train_config"]
    root = Path(spec["root"])
    whole = api.train(cfg, str(root / f"own_{rank}"), device="cpu", verbose=False)
    shared = str(root / "shared")
    api.train(cfg.replace(epochs=1), shared, device="cpu", verbose=False)
    resumed = api.train(cfg, shared, device="cpu", verbose=False, resume=True)
    return {"whole": whole.history, "resumed": resumed.history,
            "params": dict(whole.model.state_dict())}


def main(spec_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    multihost.initialize()
    mesh = make_mesh()
    spec = torch.load(spec_path, weights_only=False)
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "axis_names": mesh.axis_names,
           "env": "torchrun" if "RANK" in os.environ else "mmvae",
           "placements": placements(spec, mesh),
           "steps": dp_steps(spec, mesh), "evals": evals(spec, mesh),
           "workdirs": workdirs(spec, mesh.rank)}
    torch.save(out, out_path)
    multihost.sync()


if __name__ == "__main__":
    main(*sys.argv[1:])
