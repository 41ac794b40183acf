"""KL annealing schedule (port of ``mmvae_tpu/core/annealing.py``).

beta ramps linearly from 0 to 1 over ``annealing_steps`` global steps and
stays at 1 after; ``annealing_steps = annealing_epochs * steps_per_epoch``
gives the reference's per-batch ramp.
"""

from __future__ import annotations

__all__ = ["annealing_factor"]


def annealing_factor(step: int, annealing_steps: int) -> float:
    """``min(step / annealing_steps, 1)``; 1 from step 0 when
    ``annealing_steps <= 0`` (no annealing)."""
    if annealing_steps <= 0:
        return 1.0
    return min(step / annealing_steps, 1.0)
