"""The data-parallel mesh, the ``(data, model)`` mesh of tensor parallelism,
and the placement of batches and state on them (port of
``mmvae_tpu/parallel/mesh.py`` and of ``make_mesh_2d``,
``mmvae_tpu/parallel/tp.py:86-106``); the ``(data, pipe)`` mesh of pipeline
parallelism is the same fold with the minor axis named ``"pipe"``
(``pp.py``).

JAX's DP is GSPMD: one process holds the global batch sharded over its
devices, and XLA inserts the gradient ``psum``. In PyTorch the idiom is one
process a card, so the port's mesh is a ``torch.distributed`` process group
and a ``DeviceMesh`` with JAX's axis names over it: ``("data",)``, or
``("dcn", "data")`` over ``n_slices`` slices. Each rank holds its rows of
every global batch (:func:`shard_batch`) and a full copy of the parameters
and the optimizer state (:func:`replicate`); the train step reduces the
gradient once a step over the mesh's group (``train/step.py``). FSDP
(``fsdp.py``) shards the state over the same data mesh.

:func:`make_mesh_2d` folds the ranks into ``(data, model)``: rank ``r`` at
data ``r // tp`` and model ``r % tp`` (the model axis minor, as JAX's), with
a process group along each axis. The ranks of one model group hold the same
rows of every batch and shards of the same parameters (``tp.py``); the
gradient is reduced over the data group. A ``"pipe"`` axis in the minor
place is read the same way: the ranks of one pipe group hold the same rows
and each its stage of the trunks (``pp.py``).

The rule that keeps a run equal at any world size is the JAX package's:
every rank draws each random tensor at its global shape from a generator
kept in lockstep and keeps its own rows (:meth:`Mesh.rows`).
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "make_mesh",
    "make_mesh_2d",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate",
]


MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
# The axes the batch is not sharded over: each rank of a group along one
# holds the same rows.
_INNER_AXES = (MODEL_AXIS, PIPE_AXIS)


class Mesh:
    """A mesh over ranks of the default process group.

    ``group`` is the group of its ranks (the default group when it spans
    them all), ``size`` the ranks, ``rank`` this process's index among
    them and ``backend`` the group's (``"nccl"`` or ``"gloo"``);
    :attr:`device_mesh` is for the layers that place DTensors on the mesh.

    The batch is sharded over every axis but ``"model"`` and ``"pipe"``:
    ``n_shards`` shards, this rank's ``shard`` of them (the rank on a data
    mesh, its data coordinate on a ``(data, model)`` or ``(data, pipe)``
    mesh), and the gradient is reduced over ``data_group``. A mesh with a
    ``"model"`` or ``"pipe"`` axis has a group along each axis (``groups``)
    and this rank's coordinate on each (``coords``) and its ranks in order
    (``members``, ranks of the default group); ``model_group``,
    ``model_size`` and ``model_rank`` are the model axis's, ``pipe_group``,
    ``pipe_size`` and ``pipe_rank`` the pipe axis's (None, 1 and 0 without
    one)."""

    def __init__(self, ranks: list[int], axis_names: tuple[str, ...], shape: tuple[int, ...]):
        world = dist.get_world_size()
        self.ranks = list(ranks)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.size = len(self.ranks)
        self.group = None if self.ranks == list(range(world)) else dist.new_group(self.ranks)
        self.rank = dist.get_rank(self.group)
        self.backend = dist.get_backend(self.group)
        self.groups, self.coords, self.members = {}, {}, {}
        inner = [a for a in self.axis_names if a in _INNER_AXES]
        if inner:
            if len(self.axis_names) != 2 or len(inner) != 1:
                raise ValueError(f"a mesh with a {inner[0]} axis is 2-D (data, {inner[0]}), "
                                 f"got {self.axis_names}")
            grid = torch.tensor(self.ranks).reshape(tuple(shape))
            for axis_i, axis in enumerate(self.axis_names):
                lines = grid.movedim(axis_i, -1).reshape(-1, grid.shape[axis_i]).tolist()
                # Every rank makes every group, in the same order.
                for line in lines:
                    group = dist.new_group(line)
                    if self.ranks[self.rank] in line:
                        self.groups[axis], self.members[axis] = group, line
                        self.coords[axis] = line.index(self.ranks[self.rank])

    def __deepcopy__(self, memo):
        return self  # a copy of a model built on the mesh runs on the same groups

    @property
    def model_size(self) -> int:
        return self.shape.get(MODEL_AXIS, 1)

    @property
    def model_rank(self) -> int:
        return self.coords.get(MODEL_AXIS, 0)

    @property
    def model_group(self):
        return self.groups.get(MODEL_AXIS)

    @property
    def pipe_size(self) -> int:
        return self.shape.get(PIPE_AXIS, 1)

    @property
    def pipe_rank(self) -> int:
        return self.coords.get(PIPE_AXIS, 0)

    @property
    def pipe_group(self):
        return self.groups.get(PIPE_AXIS)

    @property
    def _inner_size(self) -> int:
        return self.model_size * self.pipe_size

    @property
    def n_shards(self) -> int:
        """The shards of the batch: the ranks over the model or pipe axis."""
        return self.size // self._inner_size

    @property
    def shard(self) -> int:
        """This rank's shard of the batch (its data coordinate)."""
        return self.rank // self._inner_size

    @property
    def data_group(self):
        """The group the gradient is reduced over: the ranks of this rank's
        model or pipe coordinate (every rank on a mesh without such an
        axis)."""
        (data_axis,) = [a for a in self.axis_names if a not in _INNER_AXES] or [None]
        return self.groups[data_axis] if self.groups else self.group

    @functools.cached_property
    def device_mesh(self):
        """The ``DeviceMesh`` of the mesh's ranks with ``axis_names``, built
        on first use (a 2-D one forms a group along each axis)."""
        from torch.distributed.device_mesh import DeviceMesh

        return DeviceMesh("cuda" if self.backend == "nccl" else "cpu",
                          torch.tensor(self.ranks).reshape(tuple(self.shape.values())),
                          mesh_dim_names=self.axis_names)

    def rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's contiguous block of ``t`` along ``dim`` (a global
        batch axis): block ``shard`` of ``n_shards`` equal blocks (the
        ranks of one model or pipe group get the same rows)."""
        n = t.shape[dim]
        if n % self.n_shards:
            raise ValueError(f"{n} rows do not divide over {self.n_shards} ranks")
        b = n // self.n_shards
        return t.narrow(dim, self.shard * b, b)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, backend={self.backend!r})"


def make_mesh(devices=None, axis_name: str = "data", n_slices: int = 1) -> Mesh:
    """The data-parallel mesh (``mesh.py:28-49``). ``devices`` are ranks of
    the default process group, one card each (all of them by default; the
    group must be up: ``parallel.multihost.initialize``). ``n_slices ==
    1``: a 1-D ``(axis_name,)`` mesh; ``n_slices > 1``: 2-D ``("dcn",
    axis_name)``, slice-major, whose gradient reduction spans both axes
    (one all-reduce over every rank, as GSPMD's hierarchical one sums the
    same terms)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "mmvae_torch.parallel.multihost.initialize() first")
    ranks = list(range(dist.get_world_size())) if devices is None else [int(d) for d in devices]
    if n_slices == 1:
        return Mesh(ranks, (axis_name,), (len(ranks),))
    if len(ranks) % n_slices:
        raise ValueError(f"{len(ranks)} devices not divisible by {n_slices} slices")
    return Mesh(ranks, ("dcn", axis_name), (n_slices, len(ranks) // n_slices))


def make_mesh_2d(tp: int, devices=None, data_axis: str = "data",
                 model_axis: str = MODEL_AXIS) -> Mesh:
    """The ``(data, model)`` mesh of tensor parallelism (``tp.py:86-106``):
    ``len(devices) / tp`` data groups of ``tp`` ranks, the model axis minor
    (rank ``r`` at data ``r // tp``, model ``r % tp``; under NCCL adjacent
    ranks are a host's cards, whose NVLink carries each layer's model-group
    collective). ``devices`` are ranks of the default group (all of them
    by default). ``model_axis="pipe"`` names the minor axis as pipeline
    parallelism does (``pp.make_mesh_pp``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh_2d needs a process group: call "
                           "mmvae_torch.parallel.multihost.initialize() first")
    ranks = list(range(dist.get_world_size())) if devices is None else [int(d) for d in devices]
    if tp < 1 or len(ranks) % tp:
        raise ValueError(f"{len(ranks)} devices not divisible by tp={tp}")
    if model_axis not in _INNER_AXES:
        raise ValueError(f"the minor axis is named {MODEL_AXIS!r} or {PIPE_AXIS!r}")
    return Mesh(ranks, (data_axis, model_axis), (len(ranks) // tp, tp))


def batch_sharding(mesh: Mesh) -> list:
    """The batch's placement on ``mesh.device_mesh``: its leading axis
    sharded over every mesh axis but the model and pipe axes (``Shard(0)``
    on each, as ``P(batch axes)``; ``Replicate()`` on those), the rows
    :func:`shard_batch` gives a rank."""
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate() if a in _INNER_AXES else Shard(0) for a in mesh.axis_names]


def replicated_sharding(mesh: Mesh) -> list:
    """The parameters' and the optimizer state's placement on
    ``mesh.device_mesh``: ``Replicate()`` on every mesh axis (``P()``)."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in mesh.axis_names]


def shard_batch(batch: dict[str, Any], mesh: Mesh, dim: int = 0) -> dict[str, Any]:
    """This rank's rows of a global batch: each tensor's block along
    ``dim`` (the batch axis; 1 for stacked ``(n_steps, B, ...)`` epochs).
    The rows must divide over the mesh, as JAX's static shapes require."""
    return {k: mesh.rows(torch.as_tensor(v), dim) for k, v in batch.items()}


def _tensors(tree: Any) -> list[torch.Tensor]:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    raise TypeError(f"replicate takes tensors, modules and containers of them, "
                    f"got {type(tree).__name__}")


def replicate(tree: Any, mesh: Mesh) -> Any:
    """``tree`` (a tensor, a module or a dict, list or tuple of them; a
    train state's are ``TrainState.tensors()``) made equal on every rank:
    each tensor broadcast in place from the mesh's first rank. Returns
    ``tree``."""
    src = mesh.ranks[0]
    with torch.no_grad():
        for t in _tensors(tree):
            if mesh.backend == "nccl" and not t.is_cuda:  # NCCL moves card memory only
                on_card = t.data.cuda()
                dist.broadcast(on_card, src, group=mesh.group)
                t.data.copy_(on_card)
            else:
                dist.broadcast(t.data, src, group=mesh.group)
    return tree
