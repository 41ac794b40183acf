"""Checkpoints, resume and best-model tracking (port of
``mmvae_tpu/train/checkpoint.py``).

The layout and its crash ordering are the JAX package's; the file format
is the port's own (Orbax depends on JAX):

  * every save writes a unique ``ckpt/last_<epoch:05d>`` directory, and
    ``ckpt/epoch_<epoch:05d>`` beside it when ``keep_epochs > 0`` (the
    newest ``keep_epochs`` of those are kept);
  * only once a save is complete does the pointer ``ckpt/last_meta.json``
    (``epoch``, ``last_dir``, ``best_dir`` and the caller's ``extra``,
    such as ``best_test_elbo``) flip, replaced whole by a temporary file
    and ``os.replace``;
  * the best pointer names the ``last_`` directory of a best epoch: a
    best epoch is never written twice;
  * superseded directories go only after the flip, and never one that the
    new pointer still names.

A kill at any instant leaves a complete checkpoint that the pointer, or
(if the pointer itself is lost) the newest ``last_`` directory, reaches.

Each directory holds one ``state.pt``, a ``torch.save`` dict of CPU
tensors, numbers and strings that :func:`load_checkpoint` reads with
``weights_only=True``: the model's and the EMA shadow's state dicts, the
optimizer's (Adam's moments and step counts), the host and device steps,
the states of the caller's named generators (the epoch order and the
noise draws, so a resumed run continues the same streams, as the JAX
state carries its rng) and ``extra`` (``epoch``, ``best_test_elbo``).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch

from mmvae_torch.train.state import TrainState

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "latest_epoch",
    "epoch_checkpoints",
]

STATE_FILE = "state.pt"


def _cpu(tree):
    """``tree`` with every tensor copied to the CPU: a checkpoint loads on
    any device."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _to_tree(
    state: TrainState, extra: dict[str, Any], generators: dict[str, torch.Generator]
) -> dict[str, Any]:
    full_extra = {"epoch": 0.0, "best_test_elbo": float("inf")}
    full_extra.update({k: float(v) for k, v in extra.items()})
    tree = {
        "step": int(state.step),
        "device_step": state.device_step,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "generators": {name: g.get_state() for name, g in generators.items()},
        "extra": full_extra,
    }
    if state.ema_model is not None:
        tree["ema_model"] = state.ema_model.state_dict()
    return _cpu(tree)


def _read_meta(ckpt_dir: str) -> dict[str, Any]:
    meta_path = os.path.join(ckpt_dir, "last_meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def _write_meta_atomic(ckpt_dir: str, meta: dict[str, Any]) -> None:
    # tmp + os.replace: a kill mid-write never leaves a truncated pointer
    # (the pointer is what makes the whole save durable).
    meta_path = os.path.join(ckpt_dir, "last_meta.json")
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, meta_path)


def _write_tree(path: str, tree: dict[str, Any]) -> None:
    """``tree`` into the directory ``path``, made complete under a name
    with a dot (which resolution skips) and then renamed. A directory at
    ``path`` already is a leftover no pointer names: the pointer flips
    only after a save completes."""
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        torch.save(tree, f)
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def save_checkpoint(
    workdir: str,
    state: TrainState,
    epoch: int,
    is_best: bool = False,
    extra: dict[str, Any] | None = None,
    keep_epochs: int = 0,
    generators: dict[str, torch.Generator] | None = None,
) -> None:
    """Write the epoch's checkpoint, then flip the pointer (the best one
    too when ``is_best``), then prune (the module docstring's ordering).

    ``keep_epochs > 0`` also writes ``ckpt/epoch_<k>`` and keeps the newest
    ``keep_epochs`` of them. ``generators`` (name -> generator) are saved
    by state.
    """
    extra = extra or {}
    tree = _to_tree(state, {"epoch": epoch, **extra}, generators or {})
    ckpt_dir = os.path.join(os.path.abspath(workdir), "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    prev = _read_meta(ckpt_dir)
    last_name = f"last_{epoch:05d}"
    _write_tree(os.path.join(ckpt_dir, last_name), tree)
    if keep_epochs > 0:
        _write_tree(os.path.join(ckpt_dir, f"epoch_{epoch:05d}"), tree)
    meta: dict[str, Any] = {"epoch": int(epoch), "last_dir": last_name}
    meta["best_dir"] = last_name if is_best else prev.get("best_dir")
    meta.update({k: float(v) for k, v in extra.items()})
    _write_meta_atomic(ckpt_dir, meta)
    live = {meta["last_dir"], meta.get("best_dir")}
    for old in (prev.get("last_dir"), prev.get("best_dir") if is_best else None):
        if old and old not in live:
            shutil.rmtree(os.path.join(ckpt_dir, old), ignore_errors=True)
    if keep_epochs > 0:
        for old in epoch_checkpoints(workdir)[:-keep_epochs]:
            shutil.rmtree(os.path.join(ckpt_dir, f"epoch_{old:05d}"), ignore_errors=True)


def _resolve_ckpt_path(ckpt_dir: str, which: str) -> str | None:
    """"last" or "best" as a checkpoint directory: the pointer's, else
    (the pointer lost) the newest complete ``<which>_<k>`` directory; for
    "best" that finds none, and the caller falls back to "last". Any
    other name (a kept ``epoch_<k>``) resolves literally. None if nothing
    exists."""
    if which not in ("last", "best"):
        p = os.path.join(ckpt_dir, which)
        return p if os.path.exists(p) else None
    name = _read_meta(ckpt_dir).get("best_dir" if which == "best" else "last_dir")
    if name and os.path.exists(os.path.join(ckpt_dir, name)):
        return os.path.join(ckpt_dir, name)
    if not os.path.isdir(ckpt_dir):
        return None
    cands = sorted(n for n in os.listdir(ckpt_dir) if n.startswith(f"{which}_") and "." not in n)
    return os.path.join(ckpt_dir, cands[-1]) if cands else None


def epoch_checkpoints(workdir: str) -> list[int]:
    """Sorted epochs with a kept ``ckpt/epoch_<k>`` directory."""
    ckpt_dir = os.path.join(os.path.abspath(workdir), "ckpt")
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("epoch_") and "." not in name:
            try:
                out.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return sorted(out)


def load_checkpoint(
    workdir: str,
    template_state: TrainState,
    which: str = "best",
    generators: dict[str, torch.Generator] | None = None,
) -> tuple[TrainState, dict[str, Any]]:
    """Load a checkpoint of :func:`save_checkpoint` into ``template_state``
    (a state of the same model and optimizer), in place, and return it and
    the checkpoint's ``extra``. "best" falls back to "last" when no best
    was written. ``generators`` (name -> generator) get their saved
    states.

    The model's and the EMA shadow's parameters are copied into their
    tensors; the optimizer's state is replaced (Adam's moments are made
    anew), so a CUDA graph runner is built after the load. The template
    keeps its own Adam form (``capturable`` on the card), whatever device
    saved the checkpoint. A checkpoint saved without an EMA shadow, loaded
    into a state that tracks one, starts the shadow from the parameters;
    a saved shadow that the state does not track is dropped. A missing or
    corrupt file raises.
    """
    ckpt_dir = os.path.join(os.path.abspath(workdir), "ckpt")
    path = _resolve_ckpt_path(ckpt_dir, which)
    if path is None and which == "best":
        path = _resolve_ckpt_path(ckpt_dir, "last")
    if path is None:
        raise FileNotFoundError(f"no checkpoint {which!r} under {ckpt_dir}")
    tree = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    state = template_state
    with torch.no_grad():
        state.model.load_state_dict(tree["model"])
        if state.ema_model is not None:
            state.ema_model.load_state_dict(tree.get("ema_model", tree["model"]))
        state.device_step.copy_(tree["device_step"])
    optimizer = tree["optimizer"]
    for saved, group in zip(optimizer["param_groups"], state.optimizer.param_groups):
        saved["capturable"] = group["capturable"]
    state.optimizer.load_state_dict(optimizer)
    state.step = int(tree["step"])
    for name, g in (generators or {}).items():
        if name not in tree["generators"]:
            raise KeyError(f"checkpoint {path} holds no state of generator {name!r}")
        g.set_state(tree["generators"][name])
    return state, dict(tree["extra"])


def latest_epoch(workdir: str) -> int | None:
    """Epoch of the last checkpoint, or None if there is none: the
    pointer's, else the newest ``last_<k>`` directory's (pointer lost)."""
    ckpt_dir = os.path.join(os.path.abspath(workdir), "ckpt")
    path = _resolve_ckpt_path(ckpt_dir, "last")
    if path is None:
        return None
    meta = _read_meta(ckpt_dir)
    if "epoch" in meta and meta.get("last_dir") == os.path.basename(path):
        return int(meta["epoch"])
    return int(os.path.basename(path).split("_", 1)[1])
