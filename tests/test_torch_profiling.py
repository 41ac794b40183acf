"""The port's profiling helpers (``mmvae_torch/utils/profiling.py``) against
the JAX package's (``mmvae_tpu/utils/profiling.py``), on the CPU: the
throughput harness on ``tests/test_utils.py:50-62``'s toy step, its
arithmetic against JAX's on one clock, ``device_barrier``'s sum against
JAX's on the same leaves, and ``trace`` writing a Chrome trace."""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.utils import measure_samples_per_sec as j_measure_samples_per_sec
from mmvae_tpu.utils.profiling import device_barrier as j_device_barrier
from mmvae_torch.utils import measure_samples_per_sec, trace
from mmvae_torch.utils.profiling import device_barrier
from torch_threads import _one_torch_thread  # noqa: F401


def _toy(zeros):
    """``tests/test_utils.py:50-62``'s step and its 10 batches of 4."""
    calls = []

    def step(state, batch):
        calls.append(batch)
        return state + 1, {"loss": zeros(()) + 1.0}

    return step, (lambda: iter([zeros(4)] * 10)), calls


def test_measure_samples_per_sec():
    step, batches, calls = _toy(torch.zeros)
    assert measure_samples_per_sec(step, 0, batches, 4, warmup=2, n_chips=1) > 0
    assert len(calls) == 2 + 10


def test_measure_samples_per_sec_is_jax_on_one_clock(monkeypatch):
    """With a clock that ticks 0.5 s a read, the port's harness and JAX's
    give the same samples a second (the warm-up untimed, the steady window
    one iterator of 10 steps of 4, over one chip: no process group here)."""
    def run(harness, zeros, **kw):
        ticks = iter(np.arange(0.0, 100.0, 0.5))
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
        step, batches, _ = _toy(zeros)
        return harness(step, 0, batches, 4, warmup=3, **kw)

    got = run(measure_samples_per_sec, torch.zeros)
    assert got == run(j_measure_samples_per_sec, jnp.zeros, n_chips=1) == 4 * 10 / 0.5
    assert run(measure_samples_per_sec, torch.zeros, n_chips=4) == got / 4


def test_device_barrier_sums_a_scalar_a_leaf_as_jax():
    rng = np.random.default_rng(0)
    leaves = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": [rng.normal(size=(5,)).astype(np.float32), np.float32(2.5)],
              "c": (rng.normal(size=(2, 2, 2)).astype(np.float32),)}
    as_torch = {"a": torch.from_numpy(leaves["a"]),
                "b": [torch.from_numpy(leaves["b"][0]), 2.5],
                "c": (torch.from_numpy(leaves["c"][0]),)}
    as_jax = {"a": jnp.asarray(leaves["a"]), "b": [jnp.asarray(leaves["b"][0]), 2.5],
              "c": (jnp.asarray(leaves["c"][0]),)}
    want = j_device_barrier(as_jax)
    assert device_barrier(as_torch) == pytest.approx(want, rel=1e-7)
    assert want == pytest.approx(sum(float(x.reshape(-1)[0]) for x in
                                     (leaves["a"], leaves["b"][0], leaves["c"][0])) + 2.5)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum().item()
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
