"""Pipeline parallelism of the port (``mmvae_torch/parallel/pp.py``,
``models/pipeline.py``) against the JAX package, on the CPU, after
``tests/test_pp.py``.

  * The schedule: a ``PipelineTrunk`` run by ``pipeline_apply`` over gloo
    ranks (``tests/torch_dp_worker.py``; the worlds and the JAX reference
    run once a test run, ``tests/torch_sharded_ref.py::worlds``) equals the
    sequential trunk, its output and the gradients of its stacked
    parameters and of its input to 1e-5, at pipe 2, pipe 4 and data 2 x
    pipe 2; a bad batch and a stage axis longer than the pipe raise.
  * The layout: the port's ``pp_param_specs`` of the full-size
    ``deep_mnist`` and ``deep_cub`` models gives every rank of a pipe group
    the elements JAX's ``pp_param_specs`` gives it, leaf by leaf, at 2 and
    4 stages (Flax trees from ``jax.eval_shape`` of the init).
  * ReZero: a fresh trunk is the identity, pipelined and not.
  * Two gloo ranks as one pipe group take 3 PP steps of ``deep_mnist`` and
    of a narrow ``deep_cub`` from JAX's init on JAX's batches and noise,
    clipping and an EMA on, each equal to JAX's single-device step; four
    ranks as data 2 x pipe 2 take ``deep_mnist``'s; every rank ends on the
    same parameters, each holding its stage of the trunks, and no step
    gathers a trunk.
  * ``api.train(pp=2)`` cuts the trunks, evaluates the whole model, writes
    from rank 0 and resumes; each invalid combination raises JAX's
    ``ValueError`` (``tests/test_pp.py:224-251``).
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mmvae_tpu.parallel.pp import pp_param_specs as j_pp_param_specs
from mmvae_torch import api, configs
from mmvae_torch.models import PipelineTrunk
from mmvae_torch.parallel import pipeline_apply, pp_param_specs
from torch_sharded_ref import (
    N_LATENTS,
    PP_MODELS,
    check_steps,
    flax_shapes,
    port_model,
    same_blocks,
    worlds,
)
from torch_threads import _one_torch_thread  # noqa: F401

TOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's steps and the ranks' results (``torch_sharded_ref.worlds``)."""
    return worlds(tmp_path_factory)


@pytest.fixture(scope="module")
def ranks(runs):
    return runs["pp"], Path(runs["dirs"]["pp"])


def _stage(p, h):
    k, b = p
    return h + torch.nn.functional.silu(h @ k[0] + b[0])


def _mesh(n_data: int, n_pipe: int):
    """What ``pipeline_apply`` reads of a mesh before it runs the schedule."""
    return types.SimpleNamespace(pipe_size=n_pipe, n_shards=n_data)


@pytest.mark.parametrize("world,pipe", [("pp", 2), ("pp4", 4), ("pp4", 2)],
                         ids=["pipe2", "pipe4", "data2_pipe2"])
def test_pipeline_apply_matches_the_sequential_trunk(runs, world, pipe):
    """``tests/test_pp.py:41-72``: the schedule's output, the gradient of
    its input rows and the gradients of the stacked parameters (summed over
    the ranks, each its stage and its rows) equal the sequential trunk's to
    1e-5 on every rank."""
    out = runs[world]
    n_data = len(out) // pipe
    assert [o["apply"][pipe]["coords"] for o in out] == [
        {"data": d, "pipe": p} for d in range(n_data) for p in range(pipe)]
    for o in out:
        got = o["apply"][pipe]
        torch.testing.assert_close(got["out"], got["want"], rtol=TOL, atol=TOL)
        torch.testing.assert_close(got["dx"], got["want_dx"], rtol=TOL, atol=TOL)
        assert set(got["grads"]) == {"kernels", "biases", "alphas"}
        for k, v in got["want_grads"].items():
            torch.testing.assert_close(got["grads"][k], v, rtol=TOL, atol=TOL, msg=k)


def test_pipeline_apply_rejects_bad_batch():
    """``tests/test_pp.py:75-82``: rows that do not divide into the
    microbatches of a data shard raise before anything moves."""
    k, b = torch.zeros((4, 1, 8, 8)), torch.zeros((4, 1, 8))
    with pytest.raises(ValueError, match="microbatch"):
        pipeline_apply(_stage, (k, b), torch.zeros((10, 8)), mesh=_mesh(1, 4), n_micro=4)
    with pytest.raises(ValueError, match="2-way data shard"):
        pipeline_apply(_stage, (k, b), torch.zeros((6, 8)), mesh=_mesh(2, 4), n_micro=4)


def test_pipeline_apply_rejects_stage_mismatch():
    """``tests/test_pp.py:254-261``: 4 stacked stages on a pipe of 2."""
    k, b = torch.zeros((4, 1, 8, 8)), torch.zeros((4, 1, 8))
    with pytest.raises(ValueError, match="pipe"):
        pipeline_apply(_stage, (k, b), torch.zeros((16, 8)), mesh=_mesh(1, 2), n_micro=2)


@pytest.mark.parametrize("name", ["deep_mnist", "deep_cub"])
def test_specs_are_jax_leaf_by_leaf(name):
    """``tests/test_pp.py:103-136``: at 2 and 4 pipe ranks each rank's block
    of every port tensor holds the elements of JAX's block of its Flax leaf:
    the trunks' kernels, biases and gates cut on their stage axis, the
    rest whole."""
    tree = flax_shapes(name)
    jspecs = j_pp_param_specs(tree)

    def jax_dim(path, leaf):
        spec = jspecs
        for k in path:
            spec = spec[k.key]
        return 0 if spec == P("pipe") else None

    specs = pp_param_specs(port_model(name))
    assert {k for k, d in specs.items() if d is not None} == {
        f"{e}.trunk.{p}" for e in ("image_enc", "image_dec")
        for p in ("kernels", "biases", "alphas")}
    for n in (2, 4):
        assert same_blocks(tree, jax_dim, specs, n) == 6


def test_rezero_trunk_is_identity_at_init(runs):
    """``tests/test_pp.py:279-309``: a fresh trunk's gates are 0, so it is
    the identity alone and pipelined over 4 ranks."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32))
    trunk = PipelineTrunk(4, 16)
    torch.nn.init.normal_(trunk.kernels)
    assert torch.equal(trunk.alphas, torch.zeros(4))
    assert torch.equal(trunk(x), x)
    assert all(o["apply"][4]["identity"] for o in runs["pp4"])
    assert "alphas" not in dict(PipelineTrunk(4, 16, rezero=False).named_parameters())


@pytest.mark.parametrize("name", list(PP_MODELS))
def test_pp_steps_match_the_jax_step(runs, ranks, name):
    """``tests/test_pp.py:139-200`` and ``:312-357``: 3 PP steps at one pipe
    group of 2 against JAX's single-device steps (the loss and the gradient
    norm at rtol 2e-4, the first step's whole gradient, the parameters and
    the EMA shadow after); both ranks end on the same parameters."""
    out, _ = ranks
    got = out[0]["steps"][name]
    check_steps(runs["jax"][name], got)
    for key in ("params", "ema"):
        for k, v in got[key].items():
            assert torch.equal(out[1]["steps"][name][key][k], v), k
    assert [o["coords"] for o in out] == [{"data": 0, "pipe": 0}, {"data": 0, "pipe": 1}]


@pytest.mark.parametrize("name", list(PP_MODELS))
def test_pp_state_holds_a_stage_and_never_gathers_it(ranks, name):
    """Each rank holds its stage of the trunks (half the stacked axis) and
    the rest whole: its persistent state is an unsharded one's less half the
    trunks' bytes of each of the parameters, Adam's two moments and the EMA
    shadow; a step (no clipping) all-reduces twice (the gradient with the
    metrics over the mesh, the norm over the pipe group) and gathers and
    reduce-scatters nothing."""
    out, _ = ranks
    for o in out:
        got = o["steps"][name]
        whole = {k: v.numel() for k, v in got["params"].items()}
        for k, shape in got["local_shapes"].items():
            split = 2 if got["dims"][k] is not None else 1
            assert int(np.prod(shape)) * split == whole[k], k
            assert got["dims"][k] == (0 if ".trunk." in k else None), k
        sharded = sum(n for k, n in whole.items() if got["dims"][k] is not None)
        assert got["bytes"] == got["bytes_alone"] - 4 * 4 * sharded // 2
        assert got["collectives"] == {"all_reduce": 2, "all_gather": 0, "reduce_scatter": 0}


@pytest.mark.parametrize("world", ["pp", "pp4"], ids=["pipe2", "data2_pipe2"])
def test_replicated_parameters_stay_equal_when_the_ranks_gradients_differ(runs, world):
    """Each rank's gradient of the replicated parameters is scaled by its
    own factor before the step's reduction (as when each rank's
    convolutions take their own algorithm): the step averages them over
    the whole mesh, so every rank still ends on the same bits, the EMA
    shadow too."""
    out = runs[world]
    want = out[0]["skewed"]
    assert want["params"]
    for o in out[1:]:
        for key in ("params", "ema"):
            for k, v in want[key].items():
                assert torch.equal(o["skewed"][key][k], v), (key, k)


def test_data_by_pipe_mesh_of_four(runs):
    """Four ranks as data 2 x pipe 2: deep_mnist's 3 steps equal JAX's, the
    two data groups on their halves of each batch, every rank on the same
    parameters."""
    out = runs["pp4"]
    assert [o["coords"] for o in out] == [{"data": d, "pipe": p} for d in (0, 1) for p in (0, 1)]
    assert [o["shard"] for o in out] == [0, 0, 1, 1]
    got = out[0]["steps"]["deep_mnist"]
    check_steps(runs["jax"]["deep_mnist"], got)
    for o in out[1:]:
        for key in ("params", "ema"):
            for k, v in got[key].items():
                assert torch.equal(o["steps"]["deep_mnist"][key][k], v), k


def test_pp_train_cuts_the_trunks_evaluates_whole_and_resumes(ranks):
    """``tests/test_pp.py:203-251``: ``api.train(pp=2)`` at world 2 holds a
    stage of each trunk a rank and returns the whole model; its last test
    ELBO is the whole EMA shadow's evaluated alone; rank 0 alone writes; one
    epoch resumed for a second gives the uninterrupted run's second record;
    the checkpoint loads into a one-process state whole; the invalid
    combinations raise."""
    out, tmp = ranks
    assert not (tmp / "own_1").exists()
    assert {"config.json", "metrics.jsonl", "ckpt"} <= {p.name for p in (tmp / "own_0").iterdir()}
    a, b = (o["workdirs"] for o in out)
    assert a["whole"] == b["whole"] and len(a["whole"]) == 2
    for o in (a, b):
        assert o["local_shapes"]["image_enc.trunk.kernels"] == (1, 1, 32, 32)
        assert o["params"]["image_enc.trunk.kernels"].shape == (2, 1, 32, 32)
        assert o["shadow_elbo"] == pytest.approx(o["whole"][-1]["test_elbo"], rel=1e-5)
        (resumed,) = o["resumed"]
        for k in ("train_loss", "test_elbo"):
            assert resumed[k] == pytest.approx(o["whole"][1][k], rel=1e-6)
        for k, v in o["params"].items():
            assert torch.equal(a["params"][k], v)
            assert torch.equal(o["loaded"][k], o["resumed_params"][k]), k
        errors = o["errors"]
        assert "mutually exclusive" in errors["fsdp"]
        assert "trunk_stages == pp" in errors["stages"]
        assert "trunk" in errors["mnist"]
        assert "must divide into 2 microbatches per 1-way data shard" in errors["micro"]


@pytest.mark.parametrize("kw,match", [
    (dict(pp=0), "pp must be >= 1"), (dict(pp=2, fsdp=True), "mutually exclusive"),
    (dict(pp=2, tp=2), "mutually exclusive"), (dict(pp=2), "divisible by pp")])
def test_train_rejects_bad_pp(kw, match):
    """The rules that need no ranks: ``pp < 1``, ``pp > 1`` with ``fsdp`` or
    ``tp``, ``pp > 1`` on ranks it does not divide or without the mesh; and
    ``build_model(pp_mesh=)`` of a config without trunks."""
    cfg = configs.get_config("deep_mnist").replace(n_latents=N_LATENTS, epochs=1,
                                                   train_size=16, test_size=8, batch_size=8, **kw)
    with pytest.raises(ValueError, match=match):
        api.train(cfg, device="cpu", verbose=False)
    with pytest.raises(ValueError, match="use_mesh"):
        api.train(cfg.replace(pp=2, fsdp=False, tp=1), device="cpu", verbose=False,
                  use_mesh=False)
    with pytest.raises(ValueError, match="no pipeline trunks"):
        configs.build_model("mnist", device="cpu", pp_mesh=_mesh(1, 2))

