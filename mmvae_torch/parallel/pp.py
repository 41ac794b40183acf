"""Pipeline parallelism (GPipe) over the ``(data, pipe)`` mesh (port of
``mmvae_tpu/parallel/pp.py``).

A trunk's stages live in stage-stacked tensors (``models/pipeline.py``):
:func:`pp_shard` gives rank ``p`` of each pipe group block ``p`` of them
(a :class:`Layout` of kind ``"pp"``, so that the EMA shadow and Adam's
moments are cut with the parameters, the norm, the checkpoints and the
eval gather the blocks as under TP and FSDP), and :func:`pipeline_apply`
runs the GPipe schedule over the group: with S stages and N microbatches,
stage 0 feeds microbatch m, each stage applies its block to what the stage
before sent it and sends the result on, and the N results of stage S - 1
are broadcast to the whole pipe group, so that what runs downstream of the
trunk (the heads, the PoE, the loss) is replicated as under plain DP. The
schedule runs the ``T = N + S - 1`` ticks of JAX's scan but not its bubble
work: a stage computes only its N real microbatches, in order, and blocks
on the send or receive between them (the bubble share is still ``(S - 1) /
T`` of each stage's time).

JAX differentiates its scan, ``ppermute`` and masked ``psum``; here the
whole schedule is one ``torch.autograd.Function`` whose backward walks it
back explicitly, in the same order on every rank (so the sends and receives
always pair up): stage S - 1 takes the cotangent of its own copy of the
output (every pipe rank holds the same loss, so one copy and not S), each
stage sends the gradient of its input to the stage before, and stage 0's
gradient of the trunk's input is broadcast to the pipe group, as JAX's
transpose sums it over ``pipe``, so that the replicated layers upstream of
the trunk get the same gradient on every rank. The batch is sharded over
the data axis only (:func:`pp_shard_batch`): every rank of a pipe group
holds the same rows, and the train step reduces the gradient over the data
group (``train/step.py``).

The activations move with ``torch.distributed``'s point-to-point ops on the
pipe group; gloo moves host memory only, so on a gloo group a card's
tensors go through the host.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from mmvae_torch.parallel.layout import Layout
from mmvae_torch.parallel.mesh import PIPE_AXIS, Mesh, make_mesh_2d, shard_batch

__all__ = [
    "make_mesh_pp",
    "pipeline_apply",
    "pp_param_specs",
    "pp_shard",
    "pp_shard_batch",
]

# The stage-stacked parameters of a ``PipelineTrunk`` (Flax's
# ``PipelineTrunk_*/{kernels, biases, alphas}``).
_TRUNK = re.compile(r"(^|\.)trunk\.(kernels|biases|alphas)$")


def make_mesh_pp(pp: int, devices=None) -> Mesh:
    """The ``(data, pipe)`` mesh (``pp.py:57-74``): ``make_mesh_2d`` with the
    minor axis named ``pipe``, ``len(devices) / pp`` data groups of ``pp``
    ranks (rank ``r`` at data ``r // pp``, pipe ``r % pp``)."""
    return make_mesh_2d(pp, devices, model_axis=PIPE_AXIS)


class _Pipe:
    """One pipe group as the schedule sees it: its ranks (global, in pipe
    order), this rank's stage, the stage function and the microbatches."""

    def __init__(self, mesh: Mesh, stage_fn: Callable, n_micro: int):
        self.group, self.size, self.stage = mesh.pipe_group, mesh.pipe_size, mesh.pipe_rank
        self.ranks = mesh.members[PIPE_AXIS]
        self.fn, self.n_micro = stage_fn, n_micro
        # gloo has no send, receive or broadcast of a card's memory.
        self.host = dist.get_backend(self.group) != "nccl"

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.size - 1

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.host and t.is_cuda else t.contiguous()

    def send(self, t: torch.Tensor, to: int) -> None:
        dist.send(self._wire(t.detach()), self.ranks[to], group=self.group)

    def recv(self, like: torch.Tensor, frm: int) -> torch.Tensor:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if self.host else like.device)
        dist.recv(buf, self.ranks[frm], group=self.group)
        return buf.to(like.device)

    def broadcast(self, t: torch.Tensor, frm: int) -> torch.Tensor:
        wire = self._wire(t)
        dist.broadcast(wire, self.ranks[frm], group=self.group)
        return wire.to(t.device)


def _forward(pipe: _Pipe, x: torch.Tensor, params: Sequence[torch.Tensor], keep: bool):
    """The forward schedule on this rank's stage: the replicated output, and
    with ``keep`` each microbatch's input and output with their graph."""
    micro = x.reshape(pipe.n_micro, -1, *x.shape[1:])
    ins, outs = [], []
    with torch.set_grad_enabled(keep):
        for m in range(pipe.n_micro):
            h = micro[m] if pipe.first else pipe.recv(micro[m], pipe.stage - 1)
            if keep:
                h = h.detach().requires_grad_(not pipe.first or x.requires_grad)
            out = pipe.fn(params, h)
            if not pipe.last:
                pipe.send(out, pipe.stage + 1)
            ins.append(h)
            outs.append(out)
    y = torch.cat([o.detach() for o in outs]) if pipe.last else torch.empty_like(x)
    return pipe.broadcast(y.reshape(x.shape), pipe.size - 1), ins, outs


class _Pipeline(torch.autograd.Function):
    """The schedule with its reverse: ``forward(x, pipe, *params)`` keeps
    each microbatch's graph on this rank's stage; ``backward`` walks the
    microbatches again with the cotangents flowing from stage S - 1 to
    stage 0."""

    @staticmethod
    def forward(ctx, x, pipe, *params):
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
        y, ctx.ins, ctx.outs = _forward(pipe, x, leaves, keep=True)
        ctx.pipe, ctx.leaves, ctx.x_meta = pipe, leaves, (x.shape, x.dtype, x.device)
        return y

    @staticmethod
    def backward(ctx, g):
        pipe, leaves = ctx.pipe, ctx.leaves
        shape, dtype, device = ctx.x_meta
        wrt = [p for p in leaves if p.requires_grad]
        grads = [torch.zeros_like(p) for p in wrt]
        if pipe.last:  # one copy of the cotangent: this rank's own
            g = torch.zeros(shape, dtype=dtype, device=device) if g is None else g
            g_micro = g.reshape(pipe.n_micro, -1, *shape[1:])
        dx = []
        for m, (h, out) in enumerate(zip(ctx.ins, ctx.outs)):
            g_out = g_micro[m] if pipe.last else pipe.recv(out, pipe.stage + 1)
            inputs = ([h] if h.requires_grad else []) + wrt
            got = torch.autograd.grad(out, inputs, g_out, allow_unused=True)
            if h.requires_grad:
                g_h, got = got[0], got[1:]
                if pipe.first:
                    dx.append(g_h)
                else:
                    pipe.send(g_h, pipe.stage - 1)
            for acc, gp in zip(grads, got):
                if gp is not None:
                    acc += gp
        ctx.ins = ctx.outs = None
        g_x = None
        if ctx.needs_input_grad[0]:  # stage 0's, on every rank of the group
            g_x = torch.cat(dx).reshape(shape) if pipe.first else \
                torch.empty(shape, dtype=dtype, device=device)
            g_x = pipe.broadcast(g_x, 0)
        it = iter(grads)
        return (g_x, None, *(next(it) if p.requires_grad else None for p in leaves))


def _stage_block(leaf: torch.Tensor, pipe: _Pipe) -> torch.Tensor:
    """This rank's stage of a stage-stacked ``leaf``: slice ``stage`` of a
    whole one, or the one block ``pp_shard`` left."""
    return leaf[0] if leaf.shape[0] == 1 else leaf[pipe.stage]


def pipeline_apply(stage_fn: Callable[[Sequence[torch.Tensor], torch.Tensor], torch.Tensor],
                   stage_params: Sequence[torch.Tensor], x: torch.Tensor, *, mesh: Mesh,
                   n_micro: int) -> torch.Tensor:
    """``x`` through the S pipelined stages (``pp.py:77-164``); the same
    shape, replicated over the pipe group.

    ``stage_params``: tensors that each have the leading stage axis, whole
    (``S = mesh.pipe_size``: this rank takes slice ``pipe_rank``) or
    this rank's block of it (length 1, as :func:`pp_shard` leaves a
    trunk). ``stage_fn(params, h) -> h`` applies one stage (``params`` its
    slices, in order) to a microbatch and keeps ``h``'s shape. ``x``: this
    rank's rows ``(B / n_data, ...)``, the same on every rank of a pipe
    group, which must divide into ``n_micro`` microbatches. Differentiable
    in ``x`` and ``stage_params`` (one backward on every rank of the group,
    as every rank computes the same loss).

    Only real microbatches run, so ``stage_fn`` never sees JAX's
    zero-filled bubble activations; it must still be total on any input
    it is given (``pp.py:97-107``).
    """
    n_stages, n_data = mesh.pipe_size, mesh.n_shards
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0] * n_data} not divisible into {n_micro} "
                         f"microbatches per {n_data}-way data shard")
    for leaf in stage_params:
        if leaf.shape[:1] not in ((n_stages,), (1,)):
            raise ValueError(f"stage_params leading axis {tuple(leaf.shape[:1])} != pipe axis "
                             f"size ({n_stages}): one stage per pipe device")
    pipe = _Pipe(mesh, stage_fn, n_micro)
    params = [_stage_block(p, pipe) for p in stage_params]
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        return _Pipeline.apply(x, pipe, *params)
    return _forward(pipe, x, params, keep=False)[0]


def pp_param_specs(model: torch.nn.Module) -> dict[str, int | None]:
    """The dim each parameter of ``model`` is cut along over the pipe axis
    (``pp.py:167-180``): 0, the stage axis, for a trunk's stage-stacked
    ``*.trunk.{kernels, biases, alphas}``; None (replicated) for the
    rest."""
    return {name: 0 if _TRUNK.search(name) else None for name, _ in model.named_parameters()}


def pp_shard(state, mesh: Mesh):
    """Place a train state of a model built with ``pp_mesh=mesh`` on the
    pipe groups (``pp.py:183-229``): each rank keeps its stage of every
    trunk parameter, of the EMA shadow's, of Adam's moments and of the
    running mean of gradient accumulation, by :func:`pp_param_specs`; the
    state gets the :class:`Layout` that the norm, the checkpoints and the
    eval gather read. Returns the state."""
    if not is_pipelined(state.model):
        raise ValueError("pp_shard needs a model built with pp_mesh (configs.build_model)")
    layout = Layout(pp_param_specs(state.model), mesh.pipe_group, mesh.pipe_size,
                    mesh.pipe_rank, kind="pp")
    return layout.place(state)


def pp_shard_batch(batch: dict[str, Any], mesh: Mesh, dim: int = 0) -> dict[str, Any]:
    """This rank's rows of a global batch, sharded over the data axis only
    (``pp.py:232-241``): every stage of a pipe group sees the same
    examples."""
    return shard_batch(batch, mesh, dim)


def is_pipelined(model: torch.nn.Module) -> bool:
    """Whether ``model`` holds a trunk that runs the schedule."""
    return any(getattr(m, "pp_mesh", None) is not None for m in model.modules())
