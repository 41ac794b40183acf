"""Tensor parallelism of the port (``mmvae_torch/parallel/tp.py``,
``models/experts.py``) against the JAX package, on the CPU.

  * ``chain_assignments`` against JAX's (pure Python) on a table of dim
    lists, and the rules' edge cases of ``tests/test_tp.py:78-116``.
  * The layout: the port's ``tp_param_specs`` of the full-size ``mnist``,
    ``celeba`` and ``cub`` models gives every rank of a model group the
    elements JAX's ``tp_param_specs`` gives it, leaf by leaf, at tp 2 and 4
    (CelebA's banks split at 2 and stay whole at 4); Flax trees from
    ``jax.eval_shape`` of the init, nothing compiled.
  * Two gloo ranks of one model group (``tests/torch_dp_worker.py``; the
    worlds and the JAX reference run once a test run,
    ``tests/torch_sharded_ref.py::worlds``) take 3
    TP steps of MNIST and of a narrow CelebA (its banks split, stage 0's K4
    on 16 channels) from JAX's init on JAX's batches and noise, clipping
    and an EMA on, each equal to JAX's single-device step
    (``tests/torch_sharded_ref.py``); each expert alone calls one
    all-reduce a row-parallel layer, a sharded bank one all-gather, and an
    MNIST step all-gathers nothing; ``api.train(tp=2)`` writes from rank 0
    and resumes.
  * Four ranks (data 2 x model 2) take MNIST's 3 steps, equal to JAX's.
  * ``api.train``'s ``ValueError``s of ``tests/test_tp.py:321-325``.
"""

from pathlib import Path

import pytest
import torch
from torch import nn

from mmvae_tpu.parallel.tp import chain_assignments as j_chain_assignments
from mmvae_tpu.parallel.tp import tp_param_specs as j_tp_param_specs
from mmvae_torch import api, configs
from mmvae_torch.parallel import chain_assignments, tp_param_specs
from torch_sharded_ref import MODELS, check_steps, flax_shapes, port_model, same_blocks, worlds

CHAINS = [
    [], [(512, 784)], [(512, 784), (512, 512), (128, 512)], [(512, 64), (784, 512)],
    [(32, 3), (64, 32), (128, 64), (256, 128)], [(33, 3), (64, 33), (128, 64)],
    [(32, 3), (63, 32), (128, 63), (256, 128)], [(18, 100), (7, 18)], [(4, 1)],
    [(12, 5), (8, 12), (6, 8)],
]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_chain_assignments_are_jax(n):
    """Col/row alternation, replication where a dim does not divide, a
    trailing col demoted: the JAX rule on every chain of the table."""
    for dims in CHAINS:
        assert chain_assignments(dims, n) == j_chain_assignments(dims, n), dims


def test_rule_edge_cases():
    """``tests/test_tp.py:78-116``'s edge cases in the port's modules: a
    module with a flat leaf of a shared divisible leading axis but no >= 3-D
    one is no bank (replicated); a Dense chain whose first layer has no bias
    gives specs of the leaves it has; 7 shards divide nothing of MNIST."""
    class Flat(nn.Module):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Parameter(torch.zeros(8, 16))

    class Mlp(nn.Module):
        def __init__(self):
            super().__init__()
            self.layers = nn.ModuleList([nn.Linear(16, 32, bias=False)])
            self.head = nn.Linear(32, 16)

    model = nn.Module()
    model.emb, model.mlp = Flat(), Mlp()
    specs = tp_param_specs(model, 2)
    assert specs == {"emb.embedding": None, "mlp.layers.0.weight": 0,
                     "mlp.head.weight": 1, "mlp.head.bias": None}
    assert all(d is None for d in tp_param_specs(port_model("mnist"),
                                                 7).values())


@pytest.mark.parametrize("name", ["mnist", "celeba", "cub"])
def test_specs_are_jax_leaf_by_leaf(name):
    """At tp 2 and 4 each model-group rank's block of every port tensor
    holds the elements of JAX's block of its Flax leaf. CelebA's stage 0 is
    column-parallel (K4 on 32 / tp channels) and its banks split at 2 only."""
    tree = flax_shapes(name)
    model = port_model(name)
    for n in (2, 4):
        jspecs = j_tp_param_specs(tree, n)

        def jax_dim(path, leaf):
            spec = jspecs
            for k in path:
                spec = spec[k.key]
            return spec.index("model") if "model" in spec else None

        specs = tp_param_specs(model, n)
        assert same_blocks(tree, jax_dim, specs, n) > 0
        if name == "celeba":
            assert specs["image_enc.convs.0.weight"] == 0
            assert specs["attr_enc.w1"] == (0 if n == 2 else None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's steps and the ranks' results (``torch_sharded_ref.worlds``)."""
    return worlds(tmp_path_factory)


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs["jax"]


@pytest.fixture(scope="module")
def ranks(runs):
    return runs["tp"], Path(runs["dirs"]["tp"])


@pytest.mark.parametrize("name", list(MODELS))
def test_tp_steps_match_the_jax_step(jax_runs, ranks, name):
    """3 TP steps at one model group of 2 against JAX's single-device
    steps; both ranks end on the same whole parameters."""
    out, _ = ranks
    got = out[0]["steps"][name]
    check_steps(jax_runs[name], got)
    for key in ("params", "ema"):
        for k, v in got[key].items():
            assert torch.equal(out[1]["steps"][name][key][k], v), k


def test_tp_collectives(ranks):
    """Each expert forward alone: one all-reduce a row-parallel layer, no
    all-gather but a sharded bank's one (CelebA's two banks split over the
    group), no reduce-scatter; an MNIST step gathers nothing (no weight is
    ever all-gathered)."""
    out, _ = ranks
    for o in out:
        for expert, f in o["forwards"].items():
            bank = expert.startswith("celeba.attr")
            assert f["calls"] == {"all_reduce": f["rows"], "all_gather": int(bank),
                                  "reduce_scatter": 0}, expert
            assert f["rows"] > 0 or bank, expert
        assert o["steps"]["mnist"]["collectives"]["all_gather"] == 0
        assert o["steps"]["mnist"]["collectives"]["reduce_scatter"] == 0
    assert [o["coords"] for o in out] == [{"data": 0, "model": 0}, {"data": 0, "model": 1}]


def test_tp_train_writes_once_and_resumes(ranks):
    """``api.train(tp=2)`` at world 2: rank 0 alone writes; both ranks
    return the same whole parameters; one epoch resumed for a second gives
    the uninterrupted run's second record; the checkpoint loads into a
    one-process state whole."""
    out, tmp = ranks
    assert not (tmp / "own_1").exists()
    assert {"config.json", "metrics.jsonl", "ckpt"} <= {p.name for p in (tmp / "own_0").iterdir()}
    a, b = (o["workdirs"] for o in out)
    assert a["whole"] == b["whole"] and len(a["whole"]) == 2
    for o in (a, b):
        (resumed,) = o["resumed"]
        for k in ("train_loss", "test_elbo"):
            assert resumed[k] == pytest.approx(o["whole"][1][k], rel=1e-6)
        for k, v in o["params"].items():
            assert torch.equal(a["params"][k], v)
            assert torch.equal(o["loaded"][k], o["resumed_params"][k]), k


def test_data_by_model_mesh_of_four(jax_runs, runs):
    """Four ranks as data 2 x model 2: MNIST's 3 steps equal JAX's, the two
    data groups on their halves of each batch, the model groups' ranks on
    the same rows."""
    out = runs["tp4"]
    assert [o["coords"] for o in out] == [{"data": d, "model": m} for d in (0, 1) for m in (0, 1)]
    check_steps(jax_runs["mnist"], out[0]["steps"]["mnist"])
    for o in out[1:]:
        for k, v in out[0]["steps"]["mnist"]["params"].items():
            assert torch.equal(o["steps"]["mnist"]["params"][k], v), k


@pytest.mark.parametrize("kw,match", [
    (dict(tp=0), "tp must be >= 1"), (dict(tp=2, fsdp=True), "mutually exclusive"),
    (dict(tp=2), "divisible by tp")])
def test_train_rejects_bad_tp(kw, match):
    """``tests/test_tp.py:321-325``: ``tp < 1``, ``tp > 1`` with ``fsdp``,
    and ``tp > 1`` on ranks it does not divide (one process) raise."""
    cfg = configs.get_config("mnist").replace(n_latents=8, epochs=1, train_size=16,
                                              test_size=8, batch_size=8, **kw)
    with pytest.raises(ValueError, match=match):
        api.train(cfg, device="cpu", verbose=False)
    with pytest.raises(ValueError, match="use_mesh"):
        api.train(configs.get_config("mnist").replace(tp=2), device="cpu", verbose=False,
                  use_mesh=False)
