"""Fully-sharded data parallelism, ZeRO-3 (port of
``mmvae_tpu/parallel/fsdp.py:35-83``).

The layout is JAX's (:func:`fsdp_sharding`): each parameter's largest dim
that divides the data axis is sharded over it (the first on a tie);
anything under ``min_size`` elements, anything with no such dim and the
scalars replicate. The rule is applied in Flax's coordinates and mapped
onto the port's tensors (``convert.flax_axes``): a ``(512, 512)`` kernel
ties and JAX shards Flax's dim 0 (its input), which is dim 1 of the
port's ``nn.Linear.weight``, so a rank holds the elements of JAX's shard.
Adam's moments and the EMA shadow shard as their parameters.

JAX leaves the collectives to GSPMD. Here they are written in the train
step (``train/step.py``), by hand rather than with ``fully_shard``
(FSDP2's default shards every parameter, pads the uneven ones and never
keeps a small one whole, and its hooks are not what a captured CUDA graph
replays): each step gathers every sharded block into a working copy of the
whole parameters (one all-gather of one flat buffer,
``Layout.gather_into``), runs the forward and the backward on it, reduces
its gradients back to the blocks (one reduce-scatter,
``Layout.reduce_scatter_grads``; the replicated ones and the loss metrics
in the step's one all-reduce) and updates the blocks. On NCCL the three
collectives are captured in the epoch's CUDA graph.
"""

from __future__ import annotations

import copy
import math

from torch import nn

from mmvae_torch.convert import flax_axes
from mmvae_torch.parallel.layout import Layout

__all__ = ["fsdp_sharding", "fsdp_layout", "fsdp_shard"]

MIN_SIZE = 2**14


def fsdp_sharding(mesh, shape: tuple[int, ...], axis_name: str = "data",
                  min_size: int = MIN_SIZE) -> int | None:
    """The dim of an array of ``shape`` that FSDP shards over ``axis_name``
    of ``mesh`` (``fsdp.py:35-55``): the largest that the axis divides, the
    first on a tie; None (replicated) under ``min_size`` elements or with
    no such dim."""
    n_shards = mesh.shape[axis_name]
    if math.prod(shape) < min_size:
        return None
    best = None
    for i, d in enumerate(shape):
        if d % n_shards == 0 and (best is None or d > shape[best]):
            best = i
    return best


def fsdp_layout(model: nn.Module, mesh, axis_name: str = "data",
                min_size: int = MIN_SIZE) -> dict[str, int | None]:
    """Each parameter's sharded dim in the port's coordinates: the rule on
    its Flax shape, mapped through ``convert.flax_axes``."""
    out = {}
    for name, axes in flax_axes(model).items():
        p = model.get_parameter(name)
        d = fsdp_sharding(mesh, tuple(p.shape[a] for a in axes), axis_name, min_size)
        out[name] = None if d is None else axes[d]
    return out


def fsdp_shard(state, mesh, axis_name: str = "data", min_size: int = MIN_SIZE):
    """Place a train state with FSDP layouts (``fsdp_shard``, ``fsdp.py:58-
    77``): each rank keeps its block of every sharded parameter, of the EMA
    shadow's, of Adam's moments and of the running mean, and the state gets
    the :class:`Layout` (``state.layout``) with the working copy of the whole
    parameters that the step computes on (``layout.work``). Returns the
    state."""
    if list(mesh.axis_names) != [axis_name]:
        raise ValueError(f"FSDP shards over a 1-D ({axis_name!r},) mesh, got {mesh.axis_names}")
    dims = fsdp_layout(state.model, mesh, axis_name, min_size)
    work = copy.deepcopy(state.model)
    layout = Layout(dims, mesh.data_group, mesh.size, mesh.rank, kind="fsdp", work=work)
    return layout.place(state)
