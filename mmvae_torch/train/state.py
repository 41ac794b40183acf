"""Train state: the model's parameters, Adam, the step and an EMA shadow
(port of ``mmvae_tpu/train/state.py``).

The JAX state is one immutable PyTree; here the model's parameters and
Adam's moments are updated in place, and :meth:`TrainState.apply_gradients`
does in order what the JAX ``tx`` chain and ``apply_gradients`` do:

  * global-norm clipping when ``grad_clip > 0``, as
    ``optax.clip_by_global_norm``: each gradient becomes ``(g / norm) *
    max`` when ``norm >= max`` and stays as it is otherwise
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and is not
    this function);
  * Adam with optax's defaults (beta 0.9 / 0.999, eps 1e-8, eps_root 0),
    ``torch.optim.Adam``, whose update is optax's up to rounding;
  * the EMA blend ``d * e + (1 - d) * p`` of the updated parameters when
    ``ema_decay > 0`` (``state.py:36-57``);
  * ``step + 1``, on the host (``step``) and on the device
    (``device_step``, which beta is read from).

On the card the update runs inside a captured CUDA graph
(``train/step.py``), so nothing in it may wait for the device: the clip
factor stays a device tensor, and Adam is built with ``capturable=True``
(its step counts live on the card). The CPU keeps the plain Adam.

Gradient accumulation (``accum_steps = k > 1``) is ``optax.MultiSteps(tx,
k)`` (``mmvae_tpu/train/state.py:33-57``, optax 0.2.6's
``MultiSteps.update``): every micro-step folds its gradients into a running
mean, ``acc + (g - acc) / (n + 1)`` at micro-step ``n`` of the update; on
the last (``n = k - 1``, the commit) the clipping, Adam and the EMA blend
run once on the mean and the mean goes back to 0; the other micro-steps
leave the parameters, Adam and the EMA as they are. ``step`` and
``device_step`` count micro-steps; Adam's count and the schedule's count
updates (commits).

The learning rate is the config's, or a schedule of the update count
(:func:`learning_rate`), read as optax reads it: at the count before the
update. On the card the rate is a 0-d float32 tensor in Adam's param group
that the update writes from ``device_step`` (so a graph replay needs no
host value); the CPU sets a float each update.

A sharded state (FSDP or tensor parallelism, ``parallel.fsdp_shard`` /
``parallel.tp_shard``) holds this rank's blocks of the parameters, of the
EMA shadow's and of Adam's moments, and its ``layout``
(``parallel.layout.Layout``); the update, the EMA blend and the
accumulation are elementwise and run on the blocks as they are, and the
global norm of the clipping and of ``grad_norm`` is the whole tree's
(:meth:`TrainState.grad_norm`: a sharded leaf's squares summed over its
group, a replicated one counted once), as ``optax.clip_by_global_norm``
of GSPMD arrays is exact. Under FSDP the step computes on
``compute_model``, the layout's working copy of the whole parameters.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable

import torch
# torch.optim imports torch._dynamo the first time an optimizer is built,
# and that import leaves a frame in a reference cycle that holds every
# frame below it: made inside api.train, the cycle would keep the run's
# model, state and captured graphs (GiBs of card memory) until Python's
# cyclic collector ran. Imported here, it holds import frames only.
import torch._dynamo  # noqa: F401
from torch import nn

__all__ = ["TrainState", "create_train_state", "global_norm", "learning_rate"]


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The 2-norm of all ``tensors`` together, as ``optax.global_norm``."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def _cosine_schedule(peak: float, warmup: int, decay: int) -> Callable:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup, decay)`` over an
    int64 count tensor, in float32 as optax computes it: ``peak * (1 - (1 -
    c / warmup))`` below ``warmup`` (``linear_schedule`` from 0), else ``peak
    * 0.5 * (1 + cos(pi * min(c - warmup, decay - warmup) / (decay -
    warmup)))``. ``decay`` must exceed ``warmup`` (optax's own
    ``ValueError`` otherwise)."""
    if not decay - warmup > 0:
        raise ValueError(
            f"the cosine decay needs positive decay steps, got {decay - warmup} "
            f"(warmup {warmup} of {decay} updates)")

    def schedule(count: torch.Tensor) -> torch.Tensor:
        ramp = torch.clamp(count, 0, warmup).to(torch.float32)
        linear = (0.0 - peak) * (1 - ramp / warmup) + peak
        t = torch.clamp(count - warmup, max=decay - warmup).to(torch.float32)
        cosine = peak * (0.5 * (1 + torch.cos(math.pi * t / float(decay - warmup))))
        return torch.where(count < warmup, linear, cosine)

    return schedule


def learning_rate(config, steps_per_epoch: int | None = None) -> float | Callable:
    """The rate of ``config`` (``mmvae_tpu/api.py:1392-1434``): a float under
    ``lr_schedule="constant"``; under ``"cosine"`` a schedule of the update
    count (an int64 tensor -> a float32 0-d tensor), the linear warmup from 0
    over ``max(1, warmup_epochs * u)`` updates and the cosine decay to 0 at
    ``max(1, epochs * u)``, ``u = max(1, steps_per_epoch // accum_steps)``
    the updates of an epoch (``steps_per_epoch`` is the loaded split's
    micro-steps; ``train_size // batch_size`` when not given). Another
    schedule raises ``ValueError``."""
    if config.lr_schedule == "constant":
        return config.learning_rate
    if config.lr_schedule == "cosine":
        if steps_per_epoch is None:
            steps_per_epoch = max(1, config.train_size // config.batch_size)
        updates = max(1, steps_per_epoch // max(1, config.accum_steps))
        return _cosine_schedule(
            config.learning_rate, max(1, config.warmup_epochs * updates),
            max(1, config.epochs * updates))
    raise ValueError(f"unknown lr_schedule {config.lr_schedule!r} (have: constant, cosine)")


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the trained ones), the optimizer over
    them, the count of micro-steps taken (``step`` on the host and
    ``device_step``, an int64 scalar on the model's device; with
    ``accum_steps = 1`` every micro-step is an update), the EMA shadow (a
    copy of the model whose parameters are the running average) when
    tracked, the schedule of the learning rate (None: the optimizer's
    constant rate) and, with ``accum_steps > 1``, the running mean of the
    gradients of the update in progress (``acc_grads``, one tensor a
    parameter)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    grad_clip: float = 0.0
    ema_model: nn.Module | None = None
    ema_decay: float = 0.0
    device_step: torch.Tensor | None = None
    accum_steps: int = 1
    schedule: Callable[[torch.Tensor], torch.Tensor] | None = None
    acc_grads: list[torch.Tensor] | None = None
    layout: Any = None

    def __post_init__(self):
        if self.device_step is None:
            self.device_step = torch.full(
                (), self.step, dtype=torch.int64, device=next(self.model.parameters()).device
            )
        if self.accum_steps > 1 and self.acc_grads is None:
            self.acc_grads = [torch.zeros_like(p) for p in self.model.parameters()]

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor of the state that a train step reads or updates in
        place: the model's parameters and buffers, ``device_step``, the EMA
        shadow's, ``acc_grads``, a tensor learning rate and Adam's moments.
        A CUDA graph holds their addresses; a data-parallel run makes them
        equal on every rank."""
        out = [*self.model.parameters(), *self.model.buffers(), self.device_step]
        if self.ema_model is not None:
            out += [*self.ema_model.parameters(), *self.ema_model.buffers()]
        if self.acc_grads is not None:
            out += self.acc_grads
        for group in self.optimizer.param_groups:
            if torch.is_tensor(group["lr"]):
                out.append(group["lr"])
        for per_param in self.optimizer.state.values():
            out += [v for v in per_param.values() if torch.is_tensor(v)]
        if self.layout is not None and self.layout.work is not None:
            out += list(self.layout.work.parameters())
        return out

    @property
    def compute_model(self) -> nn.Module:
        """The module a train step computes on: the model, or under FSDP the
        working copy of its whole parameters (``layout.work``)."""
        if self.layout is not None and self.layout.work is not None:
            return self.layout.work
        return self.model

    def grad_norm(self, grads: list[torch.Tensor] | None = None) -> torch.Tensor:
        """The global norm of ``grads`` (by default each parameter's
        ``.grad``), in the model's parameter order: :func:`global_norm`, or
        of a sharded state the whole tree's (``layout.norm``)."""
        if grads is None:
            grads = [p.grad for p in self.model.parameters()]
        if self.layout is None:
            return global_norm(grads)
        names = [n for n, _ in self.model.named_parameters()]
        return self.layout.norm(zip(names, grads))

    @property
    def micro_step(self) -> int:
        """The micro-step of the update in progress (optax's ``mini_step``)."""
        return self.step % self.accum_steps

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def ema_params(self) -> dict[str, torch.Tensor] | None:
        return None if self.ema_model is None else dict(self.ema_model.named_parameters())

    @property
    def eval_model(self) -> nn.Module:
        """The EMA shadow when tracked, else the live model (what eval and
        sampling read, as ``TrainState.eval_params`` in JAX)."""
        return self.model if self.ema_model is None else self.ema_model

    @torch.no_grad()
    def apply_gradients(self, commit: bool | None = None) -> None:
        """One micro-step from the gradients in each parameter's ``.grad``.
        With ``accum_steps = 1`` that is an update (the ``.grad`` clipped in
        place when ``grad_clip > 0``); else the gradients go into the
        running mean, and ``commit`` (by default whether this is micro-step
        ``k - 1`` of its update) updates from the mean. A CUDA graph runner
        names ``commit``, as its host step does not move under capture."""
        params = list(self.model.parameters())
        k = self.accum_steps
        if k > 1:
            grads = [p.grad for p in params]
            # acc + (g - acc) / (n + 1): optax's running mean, n the
            # micro-step of the update, read on the device.
            n1 = (self.device_step % k + 1).to(torch.float32)
            diff = torch._foreach_sub(grads, self.acc_grads)
            torch._foreach_div_(diff, n1)
            torch._foreach_add_(self.acc_grads, diff)
            if commit is None:
                commit = self.step % k == k - 1
            if commit:
                for p, acc in zip(params, self.acc_grads):
                    p.grad = acc
                self._update(params)
                for p in params:
                    p.grad = None
                torch._foreach_zero_(self.acc_grads)
        else:
            self._update(params)
        self.device_step.add_(1)
        self.step += 1

    def _update(self, params: list[torch.Tensor]) -> None:
        """Clipping, Adam at the schedule's rate and the EMA blend, from
        each parameter's ``.grad``."""
        if self.grad_clip > 0.0:
            grads = [p.grad for p in params]
            norm = self.grad_norm(grads)
            # (g / norm) * max when norm >= max, g / 1 * 1 (the same bits)
            # when not: no host sync on the card.
            fire = norm >= self.grad_clip
            div = torch.where(fire, norm, torch.ones_like(norm))
            mul = torch.where(fire, torch.full_like(norm, self.grad_clip), torch.ones_like(norm))
            for g in grads:
                g.div_(div).mul_(mul)
        if self.schedule is not None:
            count = torch.div(self.device_step, self.accum_steps, rounding_mode="floor")
            group = self.optimizer.param_groups[0]
            if torch.is_tensor(group["lr"]):
                group["lr"].copy_(self.schedule(count))
            else:
                group["lr"] = float(self.schedule(count))
        self.optimizer.step()
        if self.ema_model is not None:
            d = self.ema_decay
            for e, p in zip(self.ema_model.parameters(), params):
                e.mul_(d).add_(p, alpha=1.0 - d)


def create_train_state(
    model: nn.Module,
    learning_rate: float | Callable = 1e-3,
    grad_clip: float = 0.0,
    ema_decay: float = 0.0,
    accum_steps: int = 1,
) -> TrainState:
    """Adam over ``model``'s parameters as they are (the model was built
    with its seeded init, or loaded), and the EMA shadow initialised to
    them when ``ema_decay > 0``. ``learning_rate`` is a float or a schedule
    of the update count (:func:`learning_rate`); ``accum_steps > 1``
    averages the gradients of that many micro-steps before each update. On
    the card Adam is ``capturable`` (and its multi-tensor form, whose
    update at a rate of exactly 0 leaves the parameters as they are), so
    that a CUDA graph can hold its update, and a scheduled rate is a 0-d
    float32 tensor on the card."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    device = next(model.parameters()).device
    on_card = device.type == "cuda"
    schedule = learning_rate if callable(learning_rate) else None
    lr = learning_rate
    if schedule is not None:
        lr = torch.zeros((), dtype=torch.float32, device=device) if on_card else 0.0
    optimizer = torch.optim.Adam(
        model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
        capturable=on_card, foreach=True if on_card else None,
    )
    ema_model = None
    if ema_decay > 0.0:
        ema_model = copy.deepcopy(model)
        ema_model.requires_grad_(False)
    return TrainState(
        step=0, model=model, optimizer=optimizer, grad_clip=float(grad_clip),
        ema_model=ema_model, ema_decay=float(ema_decay), accum_steps=int(accum_steps),
        schedule=schedule,
    )
