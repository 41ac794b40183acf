"""FSDP of the port (``mmvae_torch/parallel/fsdp.py``) against the JAX
package, on the CPU.

  * The layout: the port's ``fsdp_layout`` of the full-size ``mnist``,
    ``celeba`` and ``cub`` models gives every rank the elements JAX's
    ``fsdp_sharding`` gives it, leaf by leaf, at 2 and 8 shards (the Flax
    trees from ``jax.eval_shape`` of the init: nothing compiles), and the
    rule's cases of ``tests/test_fsdp.py:40-51``.
  * Two gloo ranks (``tests/torch_dp_worker.py``; the worlds and the JAX
    reference run once a test run, ``tests/torch_sharded_ref.py::worlds``)
    take 3 FSDP steps of MNIST and of a narrow CelebA from JAX's init on
    their rows of JAX's batches and noise, clipping and an EMA on: each
    equal to JAX's single-device step (the loss and gradient norm at rtol
    2e-4, the first step's whole gradient against ``jax.value_and_grad``,
    the parameters and the shadow after), both ranks' whole parameters
    equal to the bit, a step's collectives one all-gather of the
    parameters, one reduce-scatter of the gradients and two all-reduces
    (the replicated gradients with the metrics, the norm), and each rank's
    persistent state an unsharded one's less the blocks it does not hold.
  * ``api.train(fsdp=True)`` at world 2: rank 0 alone writes, one epoch
    resumed for a second (the checkpoint cut again) gives the two
    uninterrupted epochs' second record, and the checkpoint, the same tree
    as an unsharded run's, loads into a one-process state.
"""

import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mmvae_tpu.parallel import fsdp_sharding as j_fsdp_sharding
from mmvae_tpu.parallel import make_mesh as j_make_mesh
from mmvae_torch.parallel import fsdp_layout, fsdp_sharding
from torch_sharded_ref import MODELS, check_steps, flax_shapes, port_model, same_blocks, worlds


def _mesh(n: int):
    return types.SimpleNamespace(shape={"data": n})


def test_fsdp_sharding_rule():
    """``tests/test_fsdp.py:40-51``: the largest divisible dim, the first on a
    tie; small, indivisible and scalar arrays whole."""
    mesh = _mesh(8)
    for shape in ((784, 512), (100, 512), (8,), (999, 131), (), (512, 512)):
        spec = j_fsdp_sharding(j_make_mesh(), shape).spec
        want = spec.index("data") if "data" in spec else None
        assert fsdp_sharding(mesh, shape) == want, shape
    assert fsdp_sharding(mesh, (784, 512)) == 0 and fsdp_sharding(mesh, (512, 512)) == 0


@pytest.mark.parametrize("name", ["mnist", "celeba", "cub"])
def test_layout_is_jax_leaf_by_leaf(name):
    """At 2 and 8 shards each rank's block of every port tensor holds the
    elements of JAX's block of its Flax leaf; a ``(512, 512)`` kernel,
    which ties, is cut along Flax's input axis, the port's dim 1."""
    tree = flax_shapes(name)
    model = port_model(name)
    for n in (2, 8):
        mesh = j_make_mesh(jax.devices()[:n])

        def jax_dim(path, leaf):
            spec = j_fsdp_sharding(mesh, tuple(leaf.shape)).spec
            return spec.index("data") if "data" in spec else None

        assert same_blocks(tree, jax_dim, fsdp_layout(model, _mesh(n)), n) > 0
    if name == "mnist":
        assert fsdp_layout(model, _mesh(2))["image_enc.layers.1.weight"] == 1


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's steps and the ranks' results (``torch_sharded_ref.worlds``)."""
    return worlds(tmp_path_factory)


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs["jax"]


@pytest.fixture(scope="module")
def ranks(runs):
    return runs["fsdp"], Path(runs["dirs"]["fsdp"])


@pytest.mark.parametrize("name", list(MODELS))
def test_fsdp_steps_match_the_jax_step(jax_runs, ranks, name):
    """3 FSDP steps at 2 ranks against JAX's single-device steps; both ranks
    end on the same whole parameters."""
    out, _ = ranks
    got = out[0]["steps"][name]
    check_steps(jax_runs[name], got)
    for key in ("params", "ema"):
        for k, v in got[key].items():
            assert torch.equal(out[1]["steps"][name][key][k], v), k


@pytest.mark.parametrize("name", list(MODELS))
def test_fsdp_state_is_sharded_and_its_collectives_counted(ranks, name):
    """Each rank holds the sharded leaves' blocks (half of each) and the
    replicated ones whole: its persistent state (the parameters, Adam's two
    moments and the EMA shadow, f32, and the step counts) is an unsharded
    state's less half the sharded leaves' bytes of each of the four; a step
    without clipping gathers the parameters once, reduce-scatters the
    gradients once and all-reduces twice (the replicated gradients with the
    metrics, the norm)."""
    out, _ = ranks
    for o in out:
        got = o["steps"][name]
        whole = {k: v.numel() for k, v in got["params"].items()}
        for k, shape in got["local_shapes"].items():
            split = 2 if got["dims"][k] is not None else 1
            assert int(np.prod(shape)) * split == whole[k], k
        sharded = sum(n for k, n in whole.items() if got["dims"][k] is not None)
        assert sharded > 0
        assert got["bytes"] == got["bytes_alone"] - 4 * 4 * sharded // 2
        assert got["collectives"] == {"all_reduce": 2, "all_gather": 1, "reduce_scatter": 1}


def test_fsdp_train_writes_once_and_resumes(ranks):
    """``api.train(fsdp=True)`` at world 2: rank 0's workdir holds the run,
    rank 1's does not exist; both return the same whole parameters; one
    epoch resumed for a second gives the uninterrupted run's second record
    and parameters; the checkpoint loads into a one-process state whole."""
    out, tmp = ranks
    assert not (tmp / "own_1").exists()
    assert {"config.json", "metrics.jsonl", "ckpt"} <= {p.name for p in (tmp / "own_0").iterdir()}
    a, b = (o["workdirs"] for o in out)
    assert a["whole"] == b["whole"] and len(a["whole"]) == 2
    for o in (a, b):
        (resumed,) = o["resumed"]
        assert resumed["epoch"] == 2
        for k in ("train_loss", "test_elbo"):
            assert resumed[k] == pytest.approx(o["whole"][1][k], rel=1e-6)
        for k, v in o["params"].items():
            assert torch.equal(a["params"][k], v)
            torch.testing.assert_close(o["resumed_params"][k], v, rtol=1e-5, atol=1e-6)
            assert torch.equal(o["loaded"][k], o["resumed_params"][k]), k
