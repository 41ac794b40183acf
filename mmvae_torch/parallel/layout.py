"""Sharded train state: which parameters a rank holds a slice of, and the
collectives that move between the slices and the whole (shared by FSDP,
``fsdp.py``, tensor parallelism, ``tp.py``, and pipeline parallelism,
``pp.py``).

A :class:`Layout` maps each parameter name to the dim it is sharded along
over a process group (None: replicated), rank ``r`` of ``n`` holding the
``r``-th of ``n`` equal contiguous blocks. :meth:`Layout.place` cuts a
train state down to its slices: the parameters, the EMA shadow's, Adam's
moments and the running mean of gradient accumulation, in place, so the
optimizer, the EMA blend and the accumulation (all elementwise) run on the
slices as they are. What is not elementwise reads the layout: the global
norm of the gradient (:meth:`Layout.norm`), the checkpoints (gathered to
the whole tree on save, cut again on load) and the eval, which runs on the
whole parameters (:meth:`Layout.gather_into`).
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["Layout", "all_gather_dim", "state_bytes"]

# The collectives of one tensor a rank (the names torch >= 2.10 gives them,
# else the older ones).
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _gather_flat(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """``(size, x.numel())``: every rank's ``x``, flattened, in rank order."""
    out = x.new_empty(size * x.numel())
    _all_gather(out, x.contiguous().reshape(-1), group=group)
    return out.view(size, -1)


def all_gather_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in rank order."""
    dim = dim % x.dim()
    out = _gather_flat(x, group, size).view(size, *x.shape)
    shape = list(x.shape)
    shape[dim] *= size
    return out.movedim(0, dim).reshape(shape)


def _chunks(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``x`` as ``(size, *block)``: its ``size`` blocks along ``dim``."""
    shape = list(x.shape)
    shape[dim:dim + 1] = [size, shape[dim] // size]
    return x.reshape(shape).movedim(dim, 0)


class Layout:
    """The sharding of a model's parameters over ``group`` (``size`` ranks,
    this one ``rank``): ``dims[name]`` the dim of parameter ``name`` that is
    cut into ``size`` blocks, or None where every rank holds it whole.
    ``kind`` is ``"fsdp"``, ``"tp"`` or ``"pp"``; under FSDP ``work`` is the module
    the step computes on, whose parameters are whole (:meth:`gather_into`
    fills them each step)."""

    def __init__(self, dims: dict[str, int | None], group, size: int, rank: int, kind: str,
                 work: nn.Module | None = None):
        self.dims = {k: v for k, v in dims.items()}
        self.group, self.size, self.rank, self.kind = group, size, rank, kind
        self.work = work

    def sharded(self, name: str) -> bool:
        return self.dims.get(name) is not None

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole ``full`` of parameter ``name``."""
        d = self.dims.get(name)
        if d is None:
            return full
        if full.shape[d] % self.size:
            raise ValueError(f"{name}: dim {d} of {tuple(full.shape)} does not divide over "
                             f"{self.size} ranks")
        n = full.shape[d] // self.size
        return full.narrow(d, self.rank * n, n).contiguous()

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole of parameter ``name`` from every rank's block (a
        collective: every rank calls it, in the same order)."""
        d = self.dims.get(name)
        if d is None:
            return local
        return all_gather_dim(local, d, self.group, self.size)

    @torch.no_grad()
    def place(self, state):
        """``state`` cut to this rank's blocks, in place (its model, EMA
        shadow, Adam moments and running mean), with this layout attached
        (``state.layout``). Returns the state."""
        names = [n for n, _ in state.model.named_parameters()]
        if set(self.dims) != set(names):
            raise ValueError("the layout does not name the model's parameters")

        def cut(module: nn.Module | None) -> None:
            if module is None:
                return
            for name, p in module.named_parameters():
                p.data = self.shard(name, p.data)

        cut(state.model)
        cut(state.ema_model)
        for i, (name, p) in enumerate(state.model.named_parameters()):
            for key, v in state.optimizer.state.get(p, {}).items():
                if torch.is_tensor(v) and v.dim():
                    state.optimizer.state[p][key] = self.shard(name, v)
            if state.acc_grads is not None:
                state.acc_grads[i] = self.shard(name, state.acc_grads[i])
        state.layout = self
        return state

    def norm(self, named: Iterable[tuple[str, torch.Tensor]]) -> torch.Tensor:
        """The 2-norm of the whole tensors of which ``named`` are this rank's
        blocks: the squares of the sharded ones summed over the group (one
        all-reduce), the replicated ones counted once. Every rank gets the
        same value, as ``optax.global_norm`` of the GSPMD arrays."""
        sharded, whole = [], []
        for name, t in named:
            sq = torch.linalg.vector_norm(t.float()).square()
            (sharded if self.sharded(name) else whole).append(sq)
        total = torch.stack(sharded).sum() if sharded else None
        if total is not None:
            dist.all_reduce(total, group=self.group)
        parts = ([total] if total is not None else []) + whole
        return torch.stack(parts).sum().sqrt()

    @torch.no_grad()
    def gather_into(self, src: nn.Module, dst: nn.Module) -> nn.Module:
        """``dst`` (a module of the whole parameters) given the parameters of
        which ``src``'s are this rank's blocks: one all-gather of every
        sharded block in one flat buffer, the replicated ones copied."""
        local = dict(src.named_parameters())
        names = [n for n in local if self.sharded(n)]
        whole = dict(dst.named_parameters())
        if names:
            out = _gather_flat(torch.cat([local[n].reshape(-1) for n in names]), self.group,
                               self.size)
            at = 0
            for n in names:
                blk = local[n]
                part = out[:, at:at + blk.numel()].reshape(self.size, *blk.shape)
                whole[n].copy_(part.movedim(0, self.dims[n]).reshape(whole[n].shape))
                at += blk.numel()
        for n, p in local.items():
            if n not in names:
                whole[n].copy_(p)
        return dst

    def reduce_scatter_grads(self, work: nn.Module, model: nn.Module) -> list[torch.Tensor]:
        """Each sharded parameter of ``model`` (this rank's blocks) given the
        sum over the group of ``work``'s whole gradients' blocks, divided by
        the group's size, as its ``.grad`` (one reduce-scatter of one flat
        buffer); the replicated parameters given ``work``'s gradient as it is.
        Returns the replicated parameters' gradients, for the caller's
        all-reduce."""
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in work.named_parameters()}
        params = dict(model.named_parameters())
        names = [n for n in params if self.sharded(n)]
        if names:
            flat = torch.cat([_chunks(grads[n], self.dims[n], self.size).reshape(self.size, -1)
                              for n in names], dim=1)
            out = flat.new_empty(flat.shape[1])
            _reduce_scatter(out, flat.reshape(-1), group=self.group)
            out = out / float(self.size)
            at = 0
            for n in names:
                p = params[n]
                p.grad = out[at:at + p.numel()].view_as(p)
                at += p.numel()
        rest = []
        for n, p in params.items():
            if n not in names:
                p.grad = grads[n]
                rest.append(p.grad)
        return rest


def state_bytes(state) -> int:
    """Bytes of the persistent train state a rank holds: its parameters,
    the EMA shadow's, Adam's moments and step counts, the running mean of
    gradient accumulation and the device step (not FSDP's working copy of
    the whole parameters, which a step fills and reads)."""
    work = state.layout.work if getattr(state, "layout", None) is not None else None
    skip = {t.data_ptr() for t in work.parameters()} if work is not None else set()
    seen, total = set(skip), 0
    for t in state.tensors():
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()
    return total
