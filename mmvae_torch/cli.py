"""Command line of the port: ``python -m mmvae_torch.cli <cmd> --config mnist ...``
(port of ``mmvae_tpu/cli.py``).

The subcommands and flags are the JAX CLI's: ``train``, ``eval`` (with
``--split`` and ``--iwae-k``), ``sample`` (``--out`` a ``.png`` grid or an
``.npz``), ``generate`` (``--condition-on key=file.npy`` or an inline JSON
value, ``--sample-z``, ``--temperature``) and ``export``; ``--config-file``
takes a JSON dict of config fields, flags win over it, and the commands
other than ``train`` start from the workdir's saved config. Each command
runs on ``--device`` (the card by default). ``train`` takes
``--data-dtype`` (the train split stored as bf16 or uint8),
``--eval-segment-steps``, ``--data-backend grain`` with
``--grain-stream-steps``, and the shuffle modes (``--reshuffle-every``,
``--shuffle-mode``, ``--shuffle-granularity``); ``eval --segment-steps K`` delivers the split in
segments of K batches (by default the config's). ``export`` writes the serving
artifact of ``generate`` (``serving.export_generate``: ``--out``,
``--batch-size-export`` an int or ``dynamic``, ``--sample-z``,
``--seed-mode``, ``--platforms`` of ``cuda``, ``gpu`` and ``cpu``), traced
on ``--device`` from the workdir's best weights, or from the config's
seeded init with no workdir; ``python -m mmvae_torch.serve`` serves it.
``--dtype bfloat16`` (every command) runs the experts in bf16, as the
JAX CLI passes it to every entry point (``mmvae_tpu/cli.py:362-496``).
``--multihost`` (every command) joins the process group first
(``parallel.multihost.initialize``, before any CUDA use, from JAX's
``MMVAE_*`` trio or torchrun's variables: ``torchrun --nproc_per_node N
-m mmvae_torch.cli train --multihost ...``); ``train`` then runs data
parallel over the group's ranks unless ``--no-mesh`` asks each process to
run alone (``api.train(use_mesh=False)``); ``--fsdp`` shards the state
over the ranks and ``--tp N`` runs tensor parallel over model groups of N
(``api.train``: ``config.fsdp``, ``config.tp``), and ``--pp N`` runs the
deep configs' trunks as a pipeline of N stages (``config.pp``: ``deep_mnist``
or ``deep_cub`` with ``trunk_stages == N``). Every flag and config field of
the JAX CLI is ported; ``_UNPORTED_FLAGS`` would name one that is not, which
would raise ``NotImplementedError`` when asked for.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

# The JAX CLI's flags of config fields the port does not have (dest -> flag).
_UNPORTED_FLAGS: dict[str, str] = {}
# The JAX config's fields the port does not have.
_UNPORTED_FIELDS = tuple(_UNPORTED_FLAGS)
# The config fields a flag of the same name sets (``mmvae_tpu/cli.py:48-76``).
_FIELDS = (
    "n_latents", "epochs", "batch_size", "annealing_epochs", "log_interval", "train_size",
    "test_size", "n_random_subsets", "keep_epoch_ckpts", "ema_decay", "warmup_epochs",
    "lr_schedule", "accum_steps", "nan_rollback", "objective", "mvtcae_alpha", "ckpt_every",
    "ckpt_async", "cross_recon_weight", "cross_recon_stopgrad", "unimodal_align_weight",
    "cycle_weight", "cycle_render_grad", "cycle_contrast_weight", "cycle_render_binarize",
    "p_modality_drop", "cross_recon", "data_dtype", "eval_segment_steps", "data_backend",
    "grain_stream_steps", "reshuffle_every", "shuffle_mode", "shuffle_granularity",
    "fsdp", "tp", "pp",
)
# Knobs of the mvae term structure a mixture objective clears when the
# user did not set them (``mmvae_tpu/cli.py:385-409``).
_MVAE_ONLY = (("n_random_subsets", 0), ("cross_recon", False),
              ("cross_recon_stopgrad", False), ("unimodal_align_weight", 0.0))


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to mmvae_torch")


def _add_common(p: argparse.ArgumentParser) -> None:
    from mmvae_torch.configs import CONFIGS

    p.add_argument("--config", required=True, choices=list(CONFIGS))
    p.add_argument("--workdir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the card, cuda)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype of the experts (the parameters stay float32)")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group first (MMVAE_COORDINATOR/MMVAE_NUM_PROCESSES/"
                   "MMVAE_PROCESS_ID, or torchrun's variables); train runs data parallel")


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="mmvae-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="train an experiment config")
    _add_common(pt)
    for flag, kind in (
        ("--n-latents", int), ("--epochs", int), ("--batch-size", int),
        ("--annealing-epochs", int), ("--log-interval", int), ("--train-size", int),
        ("--test-size", int), ("--n-random-subsets", int), ("--keep-epoch-ckpts", int),
        ("--accum-steps", int), ("--nan-rollback", int), ("--warmup-epochs", int),
        ("--ckpt-every", int), ("--mvtcae-alpha", float), ("--p-modality-drop", float),
        ("--cross-recon-weight", float), ("--unimodal-align-weight", float),
        ("--cycle-weight", float), ("--cycle-contrast-weight", float), ("--ema-decay", float),
    ):
        pt.add_argument(flag, dest=flag[2:].replace("-", "_"), type=kind)
    pt.add_argument("--lr", type=float)
    pt.add_argument("--objective", choices=["mvae", "mmvae", "mopoe", "mvtcae"])
    pt.add_argument("--lr-schedule", dest="lr_schedule", choices=["constant", "cosine"])
    for flag in ("--cross-recon", "--cross-recon-stopgrad", "--cycle-render-grad",
                 "--ckpt-async", "--fsdp"):
        pt.add_argument(flag, dest=flag[2:].replace("-", "_"), action="store_true",
                        default=None)
    pt.add_argument(
        "--cycle-render-binarize", dest="cycle_render_binarize", nargs="?", const=True,
        default=None, type=lambda s: True if s == "true" else s, choices=[True, "both"])
    pt.add_argument("--config-file", dest="config_file", default=None,
                    help="JSON dict of config fields applied over --config (flags win)")
    pt.add_argument("--resume", action="store_true")
    pt.add_argument("--no-mesh", action="store_true",
                    help="disable the data-parallel mesh even with >1 process")
    pt.add_argument("--data-dtype", dest="data_dtype",
                    choices=["float32", "bfloat16", "uint8"],
                    help="storage dtype of the train split's float modalities (bfloat16 "
                    "halves the bytes a step reads, uint8 quarters them; eval stays f32)")
    pt.add_argument("--eval-segment-steps", dest="eval_segment_steps", type=int,
                    help="the eval split to the device in segments of K batches (0: the "
                    "whole split resident; -1: 0)")
    pt.add_argument("--data-backend", dest="data_backend", choices=["device", "grain"],
                    help="device: the train split on the device; grain: on the host, "
                    "each epoch planned there and streamed")
    pt.add_argument("--grain-stream-steps", dest="grain_stream_steps", type=int,
                    help="grain backend: deliver each epoch in segments of K batches "
                    "(0: the whole epoch)")
    pt.add_argument("--reshuffle-every", dest="reshuffle_every", type=int,
                    help="device backend: a true reshuffle every K epochs")
    pt.add_argument("--shuffle-mode", dest="shuffle_mode", choices=["roll", "block"],
                    help="the epochs between reshuffles: roll the order, or read its "
                    "batches in a new order")
    pt.add_argument("--shuffle-granularity", dest="shuffle_granularity", type=int,
                    help="shuffle groups of G rows")
    pt.add_argument("--tp", dest="tp", type=int,
                    help="tensor parallelism: fold the ranks into a (data, model) mesh of "
                    "TP-rank model groups (needs --multihost and ranks divisible by TP)")
    pt.add_argument("--pp", dest="pp", type=int,
                    help="pipeline parallelism: fold the ranks into a (data, pipe) mesh; the "
                    "trunks run the GPipe schedule (deep_mnist or deep_cub with trunk_stages "
                    "== PP; needs --multihost and ranks divisible by PP)")

    pe = sub.add_parser("eval", help="ELBO of a split from a checkpoint")
    _add_common(pe)
    pe.add_argument("--split", default="test", choices=["train", "test"])
    pe.add_argument("--test-size", dest="test_size", type=int)
    pe.add_argument("--n-latents", dest="n_latents", type=int)
    pe.add_argument("--iwae-k", dest="iwae_k", type=int, default=0,
                    help="also the IWAE estimate of log p(x) with k samples (0: ELBO only)")
    pe.add_argument("--segment-steps", dest="segment_steps", type=int, default=None,
                    help="the split to the device in segments of K batches (default: the "
                    "config's eval_segment_steps)")

    ps = sub.add_parser("sample", help="prior samples from a checkpoint")
    _add_common(ps)
    ps.add_argument("--n", type=int, default=64)
    ps.add_argument("--temperature", type=float, default=1.0)
    ps.add_argument("--out", default=None, help="a .png grid of the images, or an .npz")
    ps.add_argument("--n-latents", dest="n_latents", type=int)

    pg = sub.add_parser("generate", help="cross-modal generation from a modality subset")
    _add_common(pg)
    pg.add_argument("--condition-on", action="append", default=[],
                    metavar="MODALITY=NPYFILE",
                    help="e.g. --condition-on image=img.npy (repeatable); label and "
                    "attribute values may be given inline: label=3, attr_6=1")
    pg.add_argument("--n", type=int, default=None)
    pg.add_argument("--sample-z", action="store_true")
    pg.add_argument("--temperature", type=float, default=1.0)
    pg.add_argument("--out", default=None)
    pg.add_argument("--n-latents", dest="n_latents", type=int)

    px = sub.add_parser("export", help="serving artifact of generate")
    _add_common(px)
    px.add_argument("--out", required=True)
    px.add_argument("--batch-size-export", dest="batch_size_export", default="8")
    px.add_argument("--sample-z", action="store_true")
    px.add_argument("--seed-mode", dest="seed_mode", default="per_row",
                    choices=["per_row", "scalar"])
    px.add_argument("--n-latents", dest="n_latents", type=int)
    px.add_argument("--platforms", default="cuda,cpu",
                    help="where the artifact may be served: cuda (or gpu) and cpu")
    return parser


def _check_ported(args) -> None:
    """Raise for every option the port does not have that ``args`` sets."""
    for dest, flag in _UNPORTED_FLAGS.items():
        if getattr(args, dest, None) is not None:
            raise _not_ported(flag)


def _overrides(args, config):
    """``config`` with the fields the flags in ``args`` set."""
    for field in _FIELDS:
        v = getattr(args, field, None)
        if v is not None:
            config = config.replace(**{field: v})
    if getattr(args, "lr", None) is not None:
        config = config.replace(learning_rate=args.lr)
    return config


def _config_file(path: str, config):
    """``config`` with the JSON dict of fields in ``path`` (``name`` is
    --config's); returns it and the fields set."""
    from mmvae_torch.api import _tuplify

    with open(path) as f:
        overrides = json.load(f)
    overrides.pop("name", None)
    unported = sorted(set(overrides) & set(_UNPORTED_FIELDS))
    if unported:
        raise _not_ported(f"the config fields {unported}")
    known = {f.name for f in dataclasses.fields(config)}
    unknown = sorted(set(overrides) - known)
    if unknown:
        raise ValueError(f"unknown config fields {unknown}")
    for field in ("model_kwargs", "data_kwargs"):
        if field in overrides:
            overrides[field] = _tuplify(overrides[field])
    return config.replace(**overrides), set(overrides)


def _resolve_config(args):
    """The config a command runs: the workdir's saved config (commands other
    than ``train``, when it was trained from ``--config``) or ``--config``'s,
    then ``--config-file``, then the flags; under a mixture objective the
    mvae-only knobs the user did not set are cleared."""
    from mmvae_torch.api import load_run_config
    from mmvae_torch.configs import get_config

    base = None
    if args.cmd != "train" and args.workdir:
        base = load_run_config(args.workdir)
        if base is not None and base.name != args.config:
            base = None
    config = base or get_config(args.config)
    explicit: set[str] = set()
    if getattr(args, "config_file", None):
        config, explicit = _config_file(args.config_file, config)
    config = _overrides(args, config)
    if config.objective != "mvae":
        inert = {field: v0 for field, v0 in _MVAE_ONLY
                 if field not in explicit and getattr(args, field, None) is None
                 and getattr(config, field) != v0}
        if inert:
            print(f"[{config.name}] objective={config.objective}: "
                  f"clearing mvae-only defaults {sorted(inert)}")
            config = config.replace(**inert)
    return config


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    _check_ported(args)
    if args.multihost:
        # Before any CUDA use: the group binds each rank to its card.
        from mmvae_torch.parallel.multihost import initialize

        initialize()

    import torch

    from mmvae_torch import api
    from mmvae_torch.device import resolve_device

    config = _resolve_config(args)
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)

    if args.cmd == "train":
        result = api.train(config, args.workdir, seed=args.seed, device=device,
                           resume=args.resume, dtype=dtype, use_mesh=not args.no_mesh)
        print(json.dumps({"best_test_elbo": result.best_test_elbo}))
        return 0

    if args.cmd == "eval":
        segs = (api.resolve_eval_segments(config) if args.segment_steps is None
                else args.segment_steps)
        out = {"split": args.split,
               "elbo": api.eval_elbo(config, workdir=args.workdir, split=args.split,
                                     device=device, segment_steps=segs, dtype=dtype)}
        if args.iwae_k > 0:
            out["log_likelihood"] = api.log_likelihood(
                config, workdir=args.workdir, split=args.split, k=args.iwae_k,
                seed=args.seed, device=device, segment_steps=segs, dtype=dtype)
            out["iwae_k"] = args.iwae_k
        print(json.dumps(out))
        return 0

    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.cmd == "sample":
        out = api.sample(config, n=args.n, workdir=args.workdir, device=device,
                         temperature=args.temperature, generator=generator, dtype=dtype)
        _dump(out, args.out, config.name)
        return 0

    if args.cmd == "generate":
        condition = {}
        for spec in args.condition_on:
            key, _, val = spec.partition("=")
            if os.path.exists(val):
                condition[key] = np.load(val)
            else:
                condition[key] = np.asarray(json.loads(val))  # an inline scalar or list
                if condition[key].ndim == 0:
                    condition[key] = condition[key][None]
        out = api.generate(config, condition, n=args.n, workdir=args.workdir, device=device,
                           sample_z=args.sample_z, temperature=args.temperature,
                           generator=generator, dtype=dtype)
        _dump(out, args.out, config.name)
        return 0

    if args.cmd == "export":
        from mmvae_torch import serving
        from mmvae_torch.configs import build_model

        bs = args.batch_size_export
        model = None
        if args.workdir is None:
            model = build_model(config, seed=args.seed, device=device)
        serving.export_generate(
            config, args.out, batch_size=bs if bs == "dynamic" else int(bs), model=model,
            workdir=args.workdir, device=device, sample_z=args.sample_z,
            platforms=tuple(args.platforms.split(",")), seed_mode=args.seed_mode, dtype=dtype)
        meta = serving.read_meta(args.out)
        print(json.dumps({"written": args.out, "bytes": os.path.getsize(args.out),
                          "batch_size": meta["batch_size"], "seed_mode": meta["seed_mode"],
                          "platforms": meta["platforms"]}))
        return 0
    return 1


def _decode_text(tokens: np.ndarray, config_name: str) -> list[str]:
    """The first 8 generated token sequences as text: CUB's captions in the
    vocabulary that sized the model (a mounted corpus's, else the synthetic
    one), MultiMNIST's digit strings (token d + 3 is digit d)."""
    if config_name == "cub":
        from mmvae_torch.configs import cub_text_vocab

        vocab = cub_text_vocab()
        return [vocab.decode(row) for row in tokens[:8]]
    return ["".join(str(int(t) - 3) for t in row if t >= 3) for row in tokens[:8]]


def _dump(out: dict, path: str | None, config_name: str = "") -> None:
    arrays = {k: v.detach().cpu().numpy() for k, v in out.items()}
    shapes = {k: list(v.shape) for k, v in arrays.items()}
    text = {"text_decoded": _decode_text(arrays["text"], config_name)} if "text" in arrays else {}
    if path and path.endswith(".png"):
        from mmvae_torch.utils import save_image_grid

        save_image_grid(arrays["image"], path)
        print(json.dumps({"written": path, "shapes": shapes, **text}))
    elif path:
        np.savez(path, **arrays)
        print(json.dumps({"written": path, "shapes": shapes, **text}))
    else:
        print(json.dumps({"shapes": shapes, **text}))


if __name__ == "__main__":
    sys.exit(main())
