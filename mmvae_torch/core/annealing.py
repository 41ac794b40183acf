"""KL annealing schedule (port of ``mmvae_tpu/core/annealing.py``).

beta ramps linearly from 0 to 1 over ``annealing_steps`` global steps and
stays at 1 after; ``annealing_steps = annealing_epochs * steps_per_epoch``
gives the reference's per-batch ramp.
"""

from __future__ import annotations

import torch

__all__ = ["annealing_factor"]


def annealing_factor(step: torch.Tensor | int, annealing_steps: int) -> torch.Tensor:
    """``min(float32(step) / annealing_steps, 1)`` as a float32 tensor on
    ``step``'s device; 1 from step 0 when ``annealing_steps <= 0`` (no
    annealing).

    ``step`` may be the train state's device step tensor: the value is
    read on the device, so a CUDA graph that captured it gives each
    replay's own beta. The divisor is a tensor on the same device, not a
    Python number: the card divides by a host scalar as a product with
    its reciprocal, which can differ from the JAX quotient in the last
    bit.
    """
    step = torch.as_tensor(step)
    if annealing_steps <= 0:
        return torch.ones((), dtype=torch.float32, device=step.device)
    total = torch.full((), float(annealing_steps), dtype=torch.float32, device=step.device)
    return torch.clamp(step.to(torch.float32) / total, max=1.0)
