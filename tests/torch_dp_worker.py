"""One rank of the gloo runs on the CPU of ``tests/test_torch_dp.py`` (two
ranks, data parallel), ``tests/test_torch_fsdp.py`` (two ranks, FSDP),
``tests/test_torch_tp.py`` (two ranks of one model group on the same two
ranks, and four as a data 2 x model 2 mesh) and ``tests/test_torch_pp.py``
(one pipe group of two on the same two ranks, and four as one pipe group of
four and as a data 2 x pipe 2 mesh).

    python tests/torch_dp_worker.py SPEC OUT

joins the process group from its environment (``parallel.multihost
.initialize``: the test gives rank 0 torchrun's variables and the others
JAX's ``MMVAE_*`` trio) and runs every scenario of ``SPEC`` (a
``torch.save`` dict the test writes; ``spec["kinds"]`` names the sharded
runs, :func:`sharded_main`), saving what it got to
``OUT``. It imports nothing of JAX: the test holds the results against the
JAX package.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch.distributed as dist  # noqa: E402

from mmvae_torch import api, configs, models  # noqa: E402
from mmvae_torch.data import Dataset  # noqa: E402
from mmvae_torch.models import MnistMVAE, PipelineTrunk  # noqa: E402
from mmvae_torch.parallel import (  # noqa: E402
    batch_sharding,
    fsdp_shard,
    make_mesh,
    make_mesh_2d,
    make_mesh_pp,
    multihost,
    pp_shard,
    replicate,
    replicated_sharding,
    shard_batch,
    state_bytes,
    tp_shard,
)
from mmvae_torch.parallel.tp import expert_kinds  # noqa: E402
from mmvae_torch.train.checkpoint import load_checkpoint  # noqa: E402
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


class _Counts:
    """The calls of each ``torch.distributed`` collective while active."""

    NAMES = ("all_reduce", "all_gather_single", "all_gather_into_tensor",
             "reduce_scatter_single", "reduce_scatter_tensor")

    def __enter__(self):
        self.calls = {n: 0 for n in self.NAMES}
        self._saved = {n: getattr(dist, n) for n in self.NAMES if hasattr(dist, n)}
        for n, fn in self._saved.items():
            def counted(*a, _n=n, _fn=fn, **k):
                self.calls[_n] += 1
                return _fn(*a, **k)
            setattr(dist, n, counted)
        # The layout module bound its collectives at import.
        from mmvae_torch.parallel import layout
        self._layout = (layout._all_gather, layout._reduce_scatter)
        layout._all_gather = lambda *a, **k: self._count("all_gather", self._layout[0], a, k)
        layout._reduce_scatter = lambda *a, **k: self._count("reduce_scatter",
                                                             self._layout[1], a, k)
        return self

    def _count(self, name, fn, a, k):
        self.calls[name] = self.calls.get(name, 0) + 1
        return fn(*a, **k)

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(dist, n, fn)
        from mmvae_torch.parallel import layout
        layout._all_gather, layout._reduce_scatter = self._layout

    def summary(self) -> dict:
        return {"all_reduce": self.calls["all_reduce"],
                "all_gather": self.calls.get("all_gather", 0),
                "reduce_scatter": self.calls.get("reduce_scatter", 0)}


_SHARD = {"fsdp": fsdp_shard, "tp": tp_shard, "pp": pp_shard}


def _sharded_state(spec: dict, name: str, mesh, kind: str, grad_clip: float | None = None):
    """``name``'s model from the JAX init, its train state, sharded."""
    m = spec["models"][name]
    cls = getattr(models, m["cls"])
    model = cls(**m["kwargs"], **({f"{kind}_mesh": mesh} if kind != "fsdp" else {}))
    model.load_state_dict(m["init"])
    state = create_train_state(model, 1e-3, ema_decay=spec["ema_decay"],
                               grad_clip=spec["grad_clip"] if grad_clip is None else grad_clip)
    return _SHARD[kind](state, mesh)


def _whole(state, module) -> dict[str, torch.Tensor]:
    return {n: state.layout.gather(n, p.detach()) for n, p in module.named_parameters()}


def sharded_steps(spec: dict, mesh, kind: str) -> dict:
    """Each model's 3 steps on this rank's rows of JAX's batches and noise
    (the "b" fold), from the JAX init, on a sharded state: the metrics, the
    whole parameters and EMA shadow after, the first step's whole gradient,
    the collectives of one step and the state's bytes."""
    out = {}
    for name, m in spec["models"].items():
        local = shard_batch({**m["batches"], "eps": m["eps"]}, mesh, dim=1)
        kw = dict(annealing_steps=spec["annealing_steps"], term_fold="b", mesh=mesh)
        # The gradient as the backward gives it (no clipping in place).
        state = _sharded_state(spec, name, mesh, kind, grad_clip=0.0)
        step = make_train_step(state.compute_model, **kw)
        with _Counts() as counts:
            step(state, {k: v[0] for k, v in local.items() if k != "eps"}, eps=local["eps"][0])
        grads = {n: state.layout.gather(n, p.grad) for n, p in state.model.named_parameters()}
        state = _sharded_state(spec, name, mesh, kind)
        runner = make_epoch_runner(state.compute_model, **kw)
        state, metrics = runner(state, local)
        # The same steps of one process alone (its own rows as the batch):
        # the bytes of its whole state.
        alone = create_train_state(getattr(models, m["cls"])(**m["kwargs"]), 1e-3,
                                   grad_clip=spec["grad_clip"], ema_decay=spec["ema_decay"])
        make_epoch_runner(alone.model, annealing_steps=spec["annealing_steps"], term_fold="b")(
            alone, local)
        out[name] = {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
                     "beta": metrics["beta"], "grads": grads, "collectives": counts.summary(),
                     "params": _whole(state, state.model),
                     "ema": _whole(state, state.ema_model),
                     "dims": dict(state.layout.dims), "bytes": state_bytes(state),
                     "bytes_alone": state_bytes(alone),
                     "local_shapes": {n: tuple(p.shape) for n, p in state.model.named_parameters()}}
    return out


def tp_forwards(spec: dict, mesh) -> dict:
    """Each expert of each model forward alone (no autograd) on the rank's
    shards: the model-group collectives it calls against its row-parallel
    layers and sharded banks."""
    out = {}
    for name, m in spec["models"].items():
        state = _sharded_state(spec, name, mesh, "tp")
        batch = {k: v[0] for k, v in m["batches"].items()}
        model = state.model
        inputs = {"image_enc": "image", "label_enc": "label", "attr_enc": "attrs"}
        with torch.no_grad():
            z = model.encode(batch)[0][:, 0]
            for expert_name, expert in model.named_children():
                with _Counts() as counts:
                    expert(batch[inputs[expert_name]] if expert_name in inputs else z)
                kinds = expert_kinds(expert, mesh.model_size)
                out[f"{name}.{expert_name}"] = {
                    "calls": counts.summary(), "rows": sum(k == "row" for k in kinds.values()),
                    "bank": expert.tp is not None and not kinds}
    return out


def sharded_workdirs(spec: dict, rank: int) -> dict:
    """``api.train`` at world 2 (``fsdp``, ``tp`` or ``pp`` set): two epochs
    into a workdir of this rank's own, then one epoch into a shared workdir
    resumed for the second (the resume cuts the checkpoint again); the
    checkpoint loaded into a one-process state (what a DP run or one card
    loads); the shapes of the blocks the run's state holds. Under ``pp``
    also the ELBO of the run's whole EMA shadow evaluated alone, and the
    ``ValueError`` of each invalid combination that needs ranks ``pp``
    divides."""
    cfg = spec["train_config"]
    root = Path(spec["root"])
    whole = api.train(cfg, str(root / f"own_{rank}"), device="cpu", verbose=False)
    shared = str(root / "shared")
    api.train(cfg.replace(epochs=1), shared, device="cpu", verbose=False)
    resumed = api.train(cfg, shared, device="cpu", verbose=False, resume=True)
    plain = configs.build_model(cfg.replace(fsdp=False, tp=1, pp=1), seed=1, device="cpu")
    loaded, _ = load_checkpoint(shared, create_train_state(plain, 1e-3), which="last")
    out = {"whole": whole.history, "resumed": resumed.history,
           "params": dict(whole.model.state_dict()),
           "resumed_params": dict(resumed.model.state_dict()),
           "loaded": {n: p.detach().clone() for n, p in loaded.model.named_parameters()},
           "local_shapes": {n: tuple(p.shape) for n, p in whole.state.model.named_parameters()}}
    if cfg.pp > 1:
        # The last test ELBO against the whole EMA shadow's, evaluated alone;
        # then each invalid combination on these ranks (pp divides them).
        shadow = whole.state.layout.gather_into(whole.state.ema_model,
                                                configs.build_model(cfg, seed=1, device="cpu"))
        out["shadow_elbo"] = api.eval_elbo(cfg, model=shadow, device="cpu")
        out["errors"] = {}
        for key, bad in {"fsdp": cfg.replace(fsdp=True),
                         "stages": cfg.replace(model_kwargs={**cfg.model_kwargs,
                                                             "trunk_stages": 4}),
                         "mnist": configs.get_config("mnist").replace(pp=2, train_size=64),
                         "micro": cfg.replace(batch_size=7)}.items():
            try:
                api.train(bad, None, device="cpu", verbose=False)
            except ValueError as e:
                out["errors"][key] = str(e)
    return out


def pp_apply(n_pipe: int) -> dict:
    """A ``PipelineTrunk`` of ``n_pipe`` stages of 2 layers 16 wide, its
    gates drawn, on a pipe mesh of ``n_pipe`` ranks (``tests/test_pp.py:41-
    72``): this rank's rows of a 16-row batch through the schedule (4
    microbatches at pipe 4, else 2), the gradients of ``(out * r).sum()``
    with respect to them and the stacked parameters summed over every rank
    (each rank's covers its stage and its rows), beside the sequential
    trunk's of the whole batch in this process; and a fresh ReZero trunk's
    output pipelined."""
    mesh = make_mesh_pp(n_pipe)
    g = torch.Generator().manual_seed(0)
    seq = PipelineTrunk(n_pipe, 16, 2)
    with torch.no_grad():
        for p in seq.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1 + (0.5 if p.dim() == 1 else 0))
    piped = PipelineTrunk(n_pipe, 16, 2, pp_mesh=mesh, pp_n_micro=4 if n_pipe == 4 else 2)
    piped.load_state_dict(seq.state_dict())
    x, r = torch.randn((16, 16), generator=g), torch.randn((16, 16), generator=g)
    xs = x.clone().requires_grad_()
    want = seq(xs)
    (want * r).sum().backward()
    xl = mesh.rows(x).clone().requires_grad_()
    out = piped(xl)
    (out * mesh.rows(r)).sum().backward()
    grads = {n: p.grad.clone() for n, p in piped.named_parameters()}
    for t in grads.values():
        dist.all_reduce(t)
    with torch.no_grad():
        piped.alphas.zero_()
        identity = torch.equal(piped(mesh.rows(x)), mesh.rows(x))
    return {"out": out.detach(), "want": mesh.rows(want.detach()), "dx": xl.grad,
            "want_dx": mesh.rows(xs.grad), "grads": grads,
            "want_grads": {n: p.grad for n, p in seq.named_parameters()},
            "identity": identity, "coords": dict(mesh.coords)}


def pp_skewed_step(spec: dict, mesh) -> dict:
    """One step of ``deep_mnist`` on a pipe mesh with each rank's gradient
    of every replicated parameter scaled by its own factor before the
    reduction, as when the ranks' convolutions take different algorithms:
    the replicated parameters and EMA shadow after it."""
    m = spec["models"]["deep_mnist"]
    local = shard_batch({**m["batches"], "eps": m["eps"]}, mesh, dim=1)
    state = _sharded_state(spec, "deep_mnist", mesh, "pp")
    skew = 1.0 + 1e-3 * dist.get_rank()
    for n, p in state.compute_model.named_parameters():
        if not state.layout.sharded(n):
            p.register_hook(lambda g: g * skew)
    step = make_train_step(state.compute_model, annealing_steps=spec["annealing_steps"],
                           term_fold="b", mesh=mesh)
    step(state, {k: v[0] for k, v in local.items() if k != "eps"}, eps=local["eps"][0])
    return {key: {n: p.detach().clone() for n, p in module.named_parameters()
                  if not state.layout.sharded(n)}
            for key, module in (("params", state.model), ("ema", state.ema_model))}


def sharded_main(spec: dict, out_path: str) -> None:
    """The sharded scenarios of each kind of ``spec["kinds"]`` (``"fsdp"``
    over every rank, ``"tp"`` over model groups of its ``tp``, ``"pp"`` over
    pipe groups of its ``pp``) on the same ranks: the steps (and under TP
    the expert forwards, under PP the schedule at each pipe size of its
    ``apply``) of the kind's ``models`` (``spec``'s by default), then
    ``api.train`` of the kind's ``train_config`` where it has one."""
    out = {"rank": dist.get_rank()}
    for kind, own in spec["kinds"].items():
        mesh = {"fsdp": make_mesh, "tp": lambda: make_mesh_2d(own["tp"]),
                "pp": lambda: make_mesh_pp(own["pp"])}[kind]()
        models = {**spec, "models": own.get("models", spec["models"])}
        res = {"shard": mesh.shard, "coords": dict(mesh.coords),
               "steps": sharded_steps(models, mesh, kind)}
        if kind == "tp":
            res["forwards"] = tp_forwards(spec, mesh)
        if kind == "pp":
            res["apply"] = {n: pp_apply(n) for n in own["apply"]}
            res["skewed"] = pp_skewed_step(models, mesh)
        if own.get("train_config") is not None:
            res["workdirs"] = sharded_workdirs(own, dist.get_rank())
        out[kind] = res
    torch.save(out, out_path)
    multihost.sync()


def main(spec_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    multihost.initialize()
    spec = torch.load(spec_path, weights_only=False)
    if "kinds" in spec:
        sharded_main(spec, out_path)
        return
    mesh = make_mesh()
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
