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

Gradient accumulation (``optax.MultiSteps``) is not ported.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

__all__ = ["TrainState", "create_train_state", "global_norm"]


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The 2-norm of all ``tensors`` together, as ``optax.global_norm``."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the trained ones), the optimizer over
    them, the count of updates taken (``step`` on the host and
    ``device_step``, an int64 scalar on the model's device), and the EMA
    shadow (a copy of the model whose parameters are the running average)
    when tracked."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    grad_clip: float = 0.0
    ema_model: nn.Module | None = None
    ema_decay: float = 0.0
    device_step: torch.Tensor | None = None

    def __post_init__(self):
        if self.device_step is None:
            self.device_step = torch.full(
                (), self.step, dtype=torch.int64, device=next(self.model.parameters()).device
            )

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
    def apply_gradients(self) -> None:
        """One update from the gradients in each parameter's ``.grad``
        (clipped in place when ``grad_clip > 0``)."""
        params = list(self.model.parameters())
        if self.grad_clip > 0.0:
            grads = [p.grad for p in params]
            norm = global_norm(grads)
            # (g / norm) * max when norm >= max, g / 1 * 1 (the same bits)
            # when not: no host sync on the card.
            fire = norm >= self.grad_clip
            div = torch.where(fire, norm, torch.ones_like(norm))
            mul = torch.where(fire, torch.full_like(norm, self.grad_clip), torch.ones_like(norm))
            for g in grads:
                g.div_(div).mul_(mul)
        self.optimizer.step()
        if self.ema_model is not None:
            d = self.ema_decay
            for e, p in zip(self.ema_model.parameters(), params):
                e.mul_(d).add_(p, alpha=1.0 - d)
        self.device_step.add_(1)
        self.step += 1


def create_train_state(
    model: nn.Module,
    learning_rate: float = 1e-3,
    grad_clip: float = 0.0,
    ema_decay: float = 0.0,
) -> TrainState:
    """Adam over ``model``'s parameters as they are (the model was built
    with its seeded init, or loaded), and the EMA shadow initialised to
    them when ``ema_decay > 0``. On the card Adam is ``capturable``, so
    that a CUDA graph can hold its update."""
    on_card = next(model.parameters()).device.type == "cuda"
    optimizer = torch.optim.Adam(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        capturable=on_card,
    )
    ema_model = None
    if ema_decay > 0.0:
        ema_model = copy.deepcopy(model)
        ema_model.requires_grad_(False)
    return TrainState(
        step=0, model=model, optimizer=optimizer, grad_clip=float(grad_clip),
        ema_model=ema_model, ema_decay=float(ema_decay),
    )
