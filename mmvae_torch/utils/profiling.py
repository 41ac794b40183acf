"""Tracing and throughput measurement (port of
``mmvae_tpu/utils/profiling.py``).

:func:`trace` is a ``torch.profiler`` context that writes a Chrome trace
(Perfetto, ``chrome://tracing``, TensorBoard's profiler plugin read it);
:func:`measure_samples_per_sec` times a step function as JAX's harness does.
Work on the card is asynchronous: a timing closes with :func:`device_barrier`,
whose fetch of a scalar of each result to the host waits for the card.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

__all__ = ["trace", "measure_samples_per_sec", "device_barrier"]


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """A ``torch.profiler`` trace of the CPU, and of the card when this
    process has put it to use, written into ``logdir`` as a Chrome trace
    (``<host>_<pid>.<ms>.pt.trace.json``) when the context ends. Yields the
    profiler (``key_averages()`` reads the events)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def device_barrier(tree) -> float:
    """Wait for the work that makes ``tree``'s tensors: one scalar a leaf
    fetched to the host. Returns the sum of the fetched scalars."""
    total = 0.0
    for leaf in tree_leaves(tree):
        if torch.is_tensor(leaf):
            total += float(leaf.detach().reshape(-1)[0].item())
        else:
            total += float(np.asarray(leaf).reshape(-1)[0])
    return total


def measure_samples_per_sec(
    step_fn: Callable,
    state,
    batch_iter: Callable[[], Iterator],
    samples_per_step: int,
    *,
    warmup: int = 3,
    n_chips: int | None = None,
) -> float:
    """Samples a second a chip of a ``(state, batch) -> (state, metrics)``
    step function: ``warmup`` steps on a fresh iterator of ``batch_iter()``
    (a callable that makes one), then every batch of another, timed to a
    :func:`device_barrier` on the last metrics. ``n_chips`` defaults to the
    process group's size when one is formed (one card a process), else 1."""
    it = batch_iter()
    for _ in range(warmup):
        state, metrics = step_fn(state, next(it))
    device_barrier(metrics)
    steps = 0
    t0 = time.perf_counter()
    for batch in batch_iter():
        state, metrics = step_fn(state, batch)
        steps += 1
    device_barrier(metrics)
    dt = time.perf_counter() - t0
    chips = n_chips or (dist.get_world_size() if dist.is_available() and dist.is_initialized()
                        else 1)
    return samples_per_step * steps / dt / chips
