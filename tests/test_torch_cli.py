"""The port's command line (``python -m mmvae_torch.cli``) and the
``split=`` of its eval entry points, on the CPU, after ``tests/test_cli.py``.

The parser is held against the JAX CLI's ``_overrides`` on the same argv;
the commands run ``main`` in process on a workdir that a tiny MNIST run
(8 latents, 64 train examples) wrote, with ``--device cpu``; the split
evals against the JAX ``eval_elbo`` and ``log_likelihood`` (rtol 2e-4,
the inference slices' tolerance) with JAX's weights and noise.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mmvae_tpu import api as japi
from mmvae_tpu.cli import _build_parser as j_build_parser
from mmvae_tpu.cli import _overrides as j_overrides
from mmvae_tpu.configs import get_config as j_get_config
from mmvae_tpu.models import MnistMVAE as JMnistMVAE
from mmvae_torch import api, configs
from mmvae_torch.cli import (
    _UNPORTED_FLAGS,
    _build_parser,
    _check_ported,
    _overrides,
    _resolve_config,
    main,
)
from mmvae_torch.convert import from_flax_params
from mmvae_torch.models import MnistMVAE

ROOT = Path(__file__).resolve().parents[1]
RTOL = 2e-4
TRAIN = ["--config", "mnist", "--epochs", "1", "--train-size", "64", "--test-size", "32",
         "--n-latents", "8", "--batch-size", "16", "--device", "cpu"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("torch_cli_run"))
    assert main(["train", "--workdir", wd, *TRAIN, "--log-interval", "2"]) == 0
    return wd


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# Every flag of a config field the two CLIs share, each set to another
# value than the mnist config's.
SHARED_ARGV = [
    "--n-latents", "12", "--epochs", "3", "--lr", "0.002", "--batch-size", "50",
    "--annealing-epochs", "4", "--log-interval", "7", "--train-size", "500",
    "--test-size", "200", "--n-random-subsets", "2", "--keep-epoch-ckpts", "3",
    "--accum-steps", "4", "--nan-rollback", "2", "--lr-schedule", "cosine",
    "--warmup-epochs", "1", "--objective", "mvtcae", "--mvtcae-alpha", "0.5",
    "--p-modality-drop", "0.25", "--cross-recon", "--cross-recon-weight", "2.0",
    "--cross-recon-stopgrad", "--unimodal-align-weight", "0.1", "--cycle-weight", "0.5",
    "--cycle-render-grad", "--cycle-render-binarize", "both",
    "--cycle-contrast-weight", "0.3", "--ema-decay", "0.99", "--ckpt-every", "2",
    "--ckpt-async", "--data-dtype", "uint8", "--eval-segment-steps", "3",
]


@pytest.mark.parametrize("argv", [SHARED_ARGV, [], ["--cycle-render-binarize"],
                                  ["--lr-schedule", "constant", "--accum-steps", "1"]])
def test_parser_sets_what_the_jax_cli_sets(argv):
    """The same train argv through the port's parser and ``_overrides`` and
    the JAX CLI's: every field both configs have comes out equal."""
    t_cfg = _overrides(_build_parser().parse_args(["train", "--config", "mnist", *argv]),
                       configs.get_config("mnist"))
    j_cfg = j_overrides(j_build_parser().parse_args(["train", "--config", "mnist", *argv]),
                        j_get_config("mnist"))
    shared = set(t_cfg.__dataclass_fields__) & set(j_cfg.__dataclass_fields__)
    assert {"accum_steps", "lr_schedule", "nan_rollback", "ckpt_async", "log_interval"} <= shared
    for field in shared:
        assert getattr(t_cfg, field) == getattr(j_cfg, field), field
    if argv is SHARED_ARGV:
        assert all(getattr(t_cfg, f) != getattr(configs.get_config("mnist"), f)
                   for f in ("accum_steps", "lr_schedule", "ckpt_async", "objective",
                             "data_dtype", "eval_segment_steps"))


def test_train_writes_the_workdir_and_records(workdir):
    assert sorted(os.listdir(workdir)) == ["ckpt", "config.json", "metrics.jsonl"]
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds == ["train", "train", "eval"]  # 4 steps, a record every 2


@pytest.mark.parametrize("split", ["test", "train"])
def test_eval_equals_eval_elbo(workdir, capsys, split):
    assert main(["eval", "--config", "mnist", "--workdir", workdir, "--device", "cpu",
                 "--split", split]) == 0
    out = _last_json(capsys)
    want = api.eval_elbo("mnist", workdir=workdir, device="cpu", split=split)
    assert out == {"split": split, "elbo": want}


def test_eval_with_iwae(workdir, capsys):
    assert main(["eval", "--config", "mnist", "--workdir", workdir, "--device", "cpu",
                 "--iwae-k", "3", "--seed", "4"]) == 0
    out = _last_json(capsys)
    assert out["iwae_k"] == 3 and np.isfinite(out["log_likelihood"])
    assert out["log_likelihood"] == api.log_likelihood(
        "mnist", workdir=workdir, k=3, seed=4, device="cpu")


def test_eval_in_segments(workdir, capsys):
    """``eval --segment-steps 1``: the ELBO and the IWAE of the split a batch
    at a time, the same numbers as the split whole."""
    for segs in ("0", "1"):
        assert main(["eval", "--config", "mnist", "--workdir", workdir, "--device", "cpu",
                     "--iwae-k", "2", "--segment-steps", segs]) == 0
        out = _last_json(capsys)
        assert out["elbo"] == api.eval_elbo("mnist", workdir=workdir, device="cpu")
        assert out["log_likelihood"] == api.log_likelihood("mnist", workdir=workdir, k=2,
                                                           device="cpu")


def test_sample_png(workdir, capsys, tmp_path):
    png = str(tmp_path / "grid.png")
    assert main(["sample", "--config", "mnist", "--workdir", workdir, "--n", "4",
                 "--out", png, "--device", "cpu"]) == 0
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert _last_json(capsys)["shapes"]["image"] == [4, 28, 28]


def test_sample_npz_equals_api_sample(workdir, capsys, tmp_path):
    npz = str(tmp_path / "s.npz")
    assert main(["sample", "--config", "mnist", "--workdir", workdir, "--n", "5",
                 "--out", npz, "--device", "cpu", "--seed", "2"]) == 0
    want = api.sample("mnist", n=5, workdir=workdir, device="cpu",
                      generator=torch.Generator().manual_seed(2))
    with np.load(npz) as f:
        assert set(f) == set(want)
        for k in want:
            np.testing.assert_array_equal(f[k], want[k].numpy())


def test_generate_inline_and_npy_conditions(workdir, capsys, tmp_path):
    npz = str(tmp_path / "gen.npz")
    assert main(["generate", "--config", "mnist", "--workdir", workdir, "--device", "cpu",
                 "--condition-on", "label=[1,2]", "--out", npz]) == 0
    with np.load(npz) as f:
        assert f["image"].shape == (2, 28, 28) and f["label"].shape == (2,)
    images = np.random.default_rng(0).random((3, 28, 28)).astype(np.float32)
    np.save(tmp_path / "img.npy", images)
    assert main(["generate", "--config", "mnist", "--workdir", workdir, "--device", "cpu",
                 "--condition-on", f"image={tmp_path / 'img.npy'}", "--sample-z",
                 "--temperature", "0.5"]) == 0
    assert _last_json(capsys)["shapes"] == {"image": [3, 28, 28], "label": [3]}
    assert main(["generate", "--config", "mnist", "--workdir", workdir, "--device", "cpu",
                 "--condition-on", "label=3"]) == 0
    assert _last_json(capsys)["shapes"]["image"] == [1, 28, 28]


SMALL_TEXT = {
    "multimnist": {"conv_features": [4, 8], "text_embed": 8, "text_hidden": 16,
                   "text_latent_dims": 4},
    "cub": {"conv_features": [8, 8]},
}


@pytest.mark.parametrize("name", list(SMALL_TEXT))
def test_generate_decodes_text(tmp_path, capsys, name):
    """MultiMNIST's generated digit strings and CUB's captions (in the
    synthetic vocabulary) are printed as text."""
    from mmvae_torch.data import cub_vocab

    cfg = {"n_latents": 8, "batch_size": 8, "train_size": 16, "test_size": 8,
           "model_kwargs": SMALL_TEXT[name]}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    wd = str(tmp_path / "wd")
    assert main(["train", "--config", name, "--workdir", wd, "--epochs", "1",
                 "--device", "cpu", "--config-file", str(path)]) == 0
    npz = str(tmp_path / "gen.npz")
    assert main(["generate", "--config", name, "--workdir", wd, "--device", "cpu",
                 "--n", "2", "--temperature", "0", "--out", npz]) == 0
    decoded = _last_json(capsys)["text_decoded"]
    with np.load(npz) as f:
        tokens = f["text"]
    assert len(decoded) == 2
    if name == "cub":
        assert decoded == [cub_vocab().decode(row) for row in tokens]
    else:
        assert decoded == ["".join(str(t - 3) for t in row if t >= 3) for row in tokens]


def test_config_file_overrides_and_flags_win(tmp_path, capsys):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"n_latents": 6, "epochs": 5, "name": "ignored",
                                "model_kwargs": {}}))
    wd = str(tmp_path / "wd")
    assert main(["train", "--config", "mnist", "--workdir", wd, "--config-file", str(path),
                 "--epochs", "1", "--train-size", "32", "--test-size", "16",
                 "--batch-size", "16", "--device", "cpu"]) == 0
    saved = api.load_run_config(wd)
    assert (saved.name, saved.n_latents, saved.epochs) == ("mnist", 6, 1)
    # eval starts from the workdir's config (6 latents) with no flags.
    assert main(["eval", "--config", "mnist", "--workdir", wd, "--device", "cpu"]) == 0
    assert np.isfinite(_last_json(capsys)["elbo"])


def test_mixture_objective_clears_mvae_only_defaults(tmp_path, capsys):
    """``--objective mopoe`` on celeba (4 random subsets by default) trains:
    the default the user did not set is cleared; set explicitly it raises
    the loss's ``ValueError``."""
    cfg = {"n_latents": 8, "batch_size": 8, "train_size": 16, "test_size": 8,
           "model_kwargs": {"conv_features": [32, 8]}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    argv = ["train", "--config", "celeba", "--epochs", "1", "--device", "cpu",
            "--config-file", str(path), "--objective", "mopoe"]
    assert main(argv) == 0
    assert "clearing mvae-only defaults ['n_random_subsets']" in capsys.readouterr().out
    with pytest.raises(ValueError, match="mvae term-structure knobs"):
        main([*argv, "--n-random-subsets", "2"])


@pytest.mark.parametrize("argv", [
    *([flag, value] for flag, value in (
        ("--data-backend", "grain"), ("--grain-stream-steps", "4"),
        ("--eval-segment-steps", "2"), ("--data-dtype", "bfloat16"),
        ("--reshuffle-every", "2"), ("--shuffle-mode", "block"),
        ("--shuffle-granularity", "8"), ("--tp", "2"), ("--pp", "2"))),
    ["--fsdp"], ["--dtype", "bfloat16"], ["--multihost"],
])
def test_unported_train_options_raise(argv, monkeypatch, tmp_path, capsys):
    """The flags of what the port does not have raise (``--pp``); the data
    flags (``--eval-segment-steps``, ``--data-dtype``, the grain backend and
    the shuffle modes) and the parallel ones (``--tp``, ``--fsdp``) are
    ported now and set their fields as the JAX CLI sets them, ``--dtype
    bfloat16`` is ported and parses as the JAX CLI parses it, and
    ``--multihost`` parses and joins a one-rank gloo group from JAX's
    ``MMVAE_*`` variables before it trains (one process: no mesh)."""
    args = ["train", "--config", "mnist", "--device", "cpu", *argv]
    if argv[0] == "--multihost":
        _multihost_env(monkeypatch)
        try:
            assert main([*args, "--n-latents", "8", "--epochs", "1", "--train-size", "16",
                         "--test-size", "8", "--batch-size", "8",
                         "--workdir", str(tmp_path / "wd")]) == 0
            assert _one_rank_gloo_group()
        finally:
            _leave_group()
        assert "best_test_elbo" in _last_json(capsys)
        return
    if argv[0] == "--dtype":
        parsed = _build_parser().parse_args(args)
        _check_ported(parsed)
        j_args = j_build_parser().parse_args(["train", "--config", "mnist", *argv])
        assert parsed.dtype == j_args.dtype == "bfloat16"
        return
    if argv[0] in _PORTED_DATA_FLAGS:
        field, value = _PORTED_DATA_FLAGS[argv[0]]
        parsed = _build_parser().parse_args(args)
        _check_ported(parsed)
        assert getattr(_resolve_config(parsed), field) == value
        return
    if argv[0] in _PORTED_PARALLEL_FLAGS:
        field, value = _PORTED_PARALLEL_FLAGS[argv[0]]
        parsed = _build_parser().parse_args(args)
        _check_ported(parsed)
        want = getattr(j_overrides(j_build_parser().parse_args(["train", "--config", "mnist",
                                                                *argv]),
                                   j_get_config("mnist")), field)
        assert getattr(_resolve_config(parsed), field) == want == value
        return
    with pytest.raises(NotImplementedError, match="not yet ported to mmvae_torch"):
        main(args)


# The data flags the port has taken: flag -> (field, the value above).
_PORTED_DATA_FLAGS = {"--eval-segment-steps": ("eval_segment_steps", 2),
                      "--data-dtype": ("data_dtype", "bfloat16"),
                      "--data-backend": ("data_backend", "grain"),
                      "--grain-stream-steps": ("grain_stream_steps", 4),
                      "--reshuffle-every": ("reshuffle_every", 2),
                      "--shuffle-mode": ("shuffle_mode", "block"),
                      "--shuffle-granularity": ("shuffle_granularity", 8)}
# The parallel flags the port has taken: flag -> (field, the value above).
_PORTED_PARALLEL_FLAGS = {"--tp": ("tp", 2), "--fsdp": ("fsdp", True)}


def test_every_unported_flag_is_covered():
    covered = {"--pp"}
    assert set(_UNPORTED_FLAGS.values()) == covered
    assert not (set(_PORTED_DATA_FLAGS) | set(_PORTED_PARALLEL_FLAGS)) & covered
    # Each ported data flag sets what the JAX CLI sets.
    argv = ["train", "--config", "mnist"]
    for flag, (field, value) in _PORTED_DATA_FLAGS.items():
        args = [*argv, flag, str(value)]
        want = getattr(j_overrides(j_build_parser().parse_args(args),
                                   j_get_config("mnist")), field)
        assert getattr(_resolve_config(_build_parser().parse_args(args)), field) == want == value


@pytest.mark.parametrize("fields", [{"fsdp": False}, {"data_kwargs": {"hw": 128}},
                                    {"grain_stream_steps": 4}, {"pp": 2}])
def test_unported_config_file_fields_raise(tmp_path, fields):
    """Fields the port does not have raise from a config file (``pp``);
    ``fsdp``, ``data_kwargs`` (its lists as tuples, as the generators take
    them) and ``grain_stream_steps`` are ported now and are set."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(fields))
    argv = ["train", "--config", "mnist", "--device", "cpu", "--config-file", str(path)]
    if "fsdp" in fields:
        assert _resolve_config(_build_parser().parse_args(argv)).fsdp is False
        return
    if "data_kwargs" in fields:
        assert _resolve_config(_build_parser().parse_args(argv)).data_kwargs == {"hw": 128}
        return
    if "grain_stream_steps" in fields:
        assert _resolve_config(_build_parser().parse_args(argv)).grain_stream_steps == 4
        return
    with pytest.raises(NotImplementedError, match="not yet ported to mmvae_torch"):
        main(argv)


def _multihost_env(monkeypatch) -> None:
    """JAX's ``MMVAE_*`` variables of a one-process group on a free port of
    this machine's loopback; torchrun's unset."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MMVAE_COORDINATOR", f"localhost:{port}")
    monkeypatch.setenv("MMVAE_NUM_PROCESSES", "1")
    monkeypatch.setenv("MMVAE_PROCESS_ID", "0")


def _one_rank_gloo_group() -> bool:
    import torch.distributed as dist

    return (dist.is_initialized() and dist.get_world_size() == 1
            and dist.get_backend() == "gloo")


def _leave_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("cmd", [
    ["export", "--config", "mnist", "--out", "x.bin", "--dtype", "bfloat16"],
    ["eval", "--config", "mnist", "--dtype", "bfloat16"],
    ["sample", "--config", "mnist", "--multihost"],
])
def test_unported_commands_raise(cmd, workdir, capsys, tmp_path, monkeypatch):
    """``--multihost`` joins a one-rank gloo group first and the command
    runs: ``sample`` of the workdir writes its npz, equal to a run without
    the flag. ``--dtype bfloat16`` runs: ``eval`` of the workdir prints the
    bf16 ELBO of ``api.eval_elbo(dtype=bf16)``, which is not the f32 one;
    ``export`` writes an artifact of the bf16 program, whose call equals
    ``api.generate(dtype=bf16)`` on the seeded init. The JAX parser reads
    the same dtype from the same argv."""
    if "--dtype" not in cmd:
        _multihost_env(monkeypatch)
        outs = [str(tmp_path / f"s{i}.npz") for i in range(2)]
        try:
            assert main([*cmd, "--workdir", workdir, "--device", "cpu", "--n", "4",
                         "--out", outs[0]]) == 0
            assert _one_rank_gloo_group()
        finally:
            _leave_group()
        assert main([*cmd[:-1], "--workdir", workdir, "--device", "cpu", "--n", "4",
                     "--out", outs[1]]) == 0
        got, want = np.load(outs[0]), np.load(outs[1])
        assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
        return
    assert j_build_parser().parse_args(cmd).dtype == "bfloat16"
    if cmd[0] == "eval":
        assert main([*cmd, "--workdir", workdir, "--device", "cpu"]) == 0
        out = _last_json(capsys)
        want = api.eval_elbo("mnist", workdir=workdir, device="cpu", dtype=torch.bfloat16)
        assert out["elbo"] == want != api.eval_elbo("mnist", workdir=workdir, device="cpu")
        return
    from mmvae_torch import serving

    path = str(tmp_path / "x.bin")
    assert main([cmd[0], "--config", "mnist", "--out", path, "--dtype", "bfloat16",
                 "--n-latents", "8", "--device", "cpu"]) == 0
    meta, call = serving.load_generate(path, device="cpu")
    label = np.arange(8) % 10
    batch = {"image": np.zeros((8, 28, 28), np.float32), "label": label}
    got = call(batch, np.tile([0.0, 1.0], (8, 1)).astype(np.float32), temperature=0.0)
    model = configs.build_model(configs.get_config("mnist").replace(n_latents=8), device="cpu")
    want = api.generate("mnist", {"label": label}, model=model, device="cpu",
                        temperature=0.0, dtype=torch.bfloat16)
    torch.testing.assert_close(got["image"], want["image"], rtol=1e-6, atol=1e-6)


def test_module_runs_and_refuses_the_card_when_there_is_none(tmp_path):
    """``python -m mmvae_torch.cli`` is the entry point; with no card and no
    ``--device`` it raises rather than fall back to the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    run = subprocess.run(
        [sys.executable, "-m", "mmvae_torch.cli", "train", "--config", "mnist",
         "--workdir", str(tmp_path)], cwd=tmp_path, env=env, capture_output=True, text=True)
    assert run.returncode != 0 and "CUDA is not available" in run.stderr
    help_run = subprocess.run([sys.executable, "-m", "mmvae_torch.cli", "--help"],
                              cwd=tmp_path, env=env, capture_output=True, text=True)
    assert help_run.returncode == 0 and "train" in help_run.stdout


# --- split= on the eval entry points, against JAX ---------------------------


@pytest.fixture(scope="module")
def matched():
    jmodel = JMnistMVAE(n_latents=8)
    params = jmodel.init(jax.random.key(0), jmodel.dummy_batch(2), rng=jax.random.key(1))
    params = jax.tree.map(np.array, params["params"])
    tmodel = MnistMVAE(n_latents=8)
    tmodel.load_state_dict(from_flax_params(params))
    return jmodel, params, tmodel


@pytest.mark.parametrize("split", ["train", "test"])
def test_eval_elbo_split_matches_jax(matched, split):
    """70 examples of the split at batch 32 (``test_size`` sizes either)."""
    jmodel, params, tmodel = matched
    j_cfg = j_get_config("mnist").replace(n_latents=8, test_size=70, batch_size=32)
    t_cfg = configs.get_config("mnist").replace(n_latents=8, test_size=70, batch_size=32)
    want = japi.eval_elbo(j_cfg, model=jmodel, params=params, split=split)
    got = api.eval_elbo(t_cfg, model=tmodel, split=split, device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_the_splits_differ(matched):
    _, _, tmodel = matched
    cfg = configs.get_config("mnist").replace(n_latents=8, test_size=70, batch_size=32)
    assert (api.eval_elbo(cfg, model=tmodel, split="train", device="cpu")
            != api.eval_elbo(cfg, model=tmodel, split="test", device="cpu"))


def test_log_likelihood_train_split_matches_jax(matched):
    """10 train examples at batch 4, k = 3, JAX's noise of each batch
    (``fold_in(key(seed), i)``) passed in."""
    jmodel, params, tmodel = matched
    n, bs, k, seed = 10, 4, 3, 3
    j_cfg = j_get_config("mnist").replace(n_latents=8, test_size=n)
    t_cfg = configs.get_config("mnist").replace(n_latents=8, test_size=n)
    want = japi.log_likelihood(j_cfg, model=jmodel, params=params, split="train", k=k,
                               batch_size=bs, seed=seed)
    key = jax.random.key(seed)
    eps = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), (bs, k, 8)))
                    for i in range(-(-n // bs))])
    got = api.log_likelihood(t_cfg, model=tmodel, split="train", k=k, batch_size=bs,
                             device="cpu", eps=torch.from_numpy(eps))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_unknown_split_raises(matched):
    _, _, tmodel = matched
    with pytest.raises(ValueError, match="unknown split"):
        api.eval_elbo("mnist", model=tmodel, split="val", device="cpu")

