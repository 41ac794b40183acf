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
under gradient accumulation the running mean of the update in progress
and its micro-step (optax's ``acc_grads`` and ``mini_step``), the states
of the caller's named generators (the epoch order and the noise draws, so
a resumed run continues the same streams, as the JAX state carries its
rng) and ``extra`` (``epoch``, ``best_test_elbo``).

:class:`AsyncCheckpointWriter` overlaps a save with training
(``mmvae_tpu/train/checkpoint.py:169-302``): the snapshot is taken in
order with the card's work, and a worker thread copies it to the host and
does the disk work in the same order as :func:`save_checkpoint`.

A sharded state (FSDP or tensor parallelism, ``state.layout``) is saved
whole: every rank gathers each sharded tensor (the parameters, the EMA
shadow's, Adam's moments, the running mean), and rank 0 writes the same
tree as a one-card or DP run, which any of them loads. A load into a
sharded state cuts the whole tree to the rank's blocks (a resume, a
``nan_rollback`` restore).
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import torch

from mmvae_torch.parallel.multihost import is_primary, process_count, sync
from mmvae_torch.train.state import TrainState

__all__ = [
    "save_checkpoint",
    "AsyncCheckpointWriter",
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


def _per_param(state: TrainState, tree: dict[str, Any], fn) -> dict[str, Any]:
    """``tree`` (a checkpoint tree of ``state``'s model) with ``fn(name,
    tensor)`` applied to every tensor that has the shape of a parameter:
    the model's and the EMA shadow's parameters, Adam's moments (by the
    parameter's index) and the running mean."""
    names = [n for n, _ in state.model.named_parameters()]
    out = dict(tree)
    for key in ("model", "ema_model"):
        if key in tree:
            out[key] = {k: fn(k, v) if k in names else v for k, v in tree[key].items()}
    opt = dict(tree["optimizer"])
    opt["state"] = {i: {k: fn(names[i], v) if torch.is_tensor(v) and v.dim() else v
                        for k, v in per.items()}
                    for i, per in tree["optimizer"]["state"].items()}
    out["optimizer"] = opt
    if "acc_grads" in tree:
        out["acc_grads"] = [fn(n, v) for n, v in zip(names, tree["acc_grads"], strict=True)]
    return out


def _to_tree(
    state: TrainState, extra: dict[str, Any], generators: dict[str, torch.Generator]
) -> dict[str, Any]:
    """The checkpoint's tree, its tensors where the state holds them (a
    sharded state's gathered whole: a collective, which every rank runs)."""
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
    if state.acc_grads is not None:
        tree["accum_steps"] = state.accum_steps
        tree["micro_step"] = state.micro_step
        tree["acc_grads"] = list(state.acc_grads)
    if state.layout is not None:
        tree = _per_param(state, tree, state.layout.gather)
    return tree


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

    In a multi-process run every rank calls it: rank 0 writes (the state
    is replicated, or a sharded state's tree is gathered on every rank
    first), and a barrier after the write holds every rank until the
    checkpoint is complete, so any rank may read it next.
    """
    extra = extra or {}
    if state.layout is not None or is_primary():
        tree = _to_tree(state, {"epoch": epoch, **extra}, generators or {})
    if is_primary():
        _serialize_and_flip(workdir, _cpu(tree), epoch, is_best, extra, keep_epochs)
    sync()


def _serialize_and_flip(
    workdir: str,
    tree: dict[str, Any],
    epoch: int,
    is_best: bool,
    extra: dict[str, Any],
    keep_epochs: int,
) -> None:
    """``tree`` (on the host) into the epoch's directories, then the
    pointer flip, then the pruning: :func:`save_checkpoint`'s disk work,
    which :class:`AsyncCheckpointWriter`'s worker runs too."""
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


def _snapshot(tree) -> tuple[Any, torch.cuda.Event | None, torch.device | None]:
    """``tree`` with each tensor cloned, in order with the work queued on
    the card so far and safe from what is queued after: a card tensor is
    cloned on the current stream (the next epoch's replays update the live
    ones in place, on that stream, after the clone). Returns the clones, an
    event recorded after them and their card (None, None when nothing is on
    the card)."""
    device = None

    def clone(t):
        nonlocal device
        if isinstance(t, torch.Tensor):
            if t.is_cuda:
                device = t.device
            return t.detach().clone()
        if isinstance(t, dict):
            return {k: clone(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(clone(v) for v in t)
        return t

    tree = clone(tree)
    if device is None:
        return tree, None, None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return tree, done, device


def _to_host(tree, done: torch.cuda.Event | None, stream: torch.cuda.Stream | None):
    """A :func:`_snapshot` on the host: once its clones are made (``done``),
    copied on ``stream``, a side stream of their card that its current
    stream does not wait for."""
    if done is None:
        return tree
    done.synchronize()
    with torch.cuda.stream(stream):
        return _cpu(tree)


class AsyncCheckpointWriter:
    """Overlapped saves (``mmvae_tpu/train/checkpoint.py:169-302``).

    :meth:`stage` (on the thread that trains) snapshots the checkpoint
    tree (:func:`_snapshot`: clones on the card's current stream and an
    event after them) and hands it to a single worker thread, which waits
    for the event, copies the clones to the host on a side stream of its
    own (:func:`_to_host`) and then does the disk work of
    :func:`save_checkpoint` in its order (``torch.save``, the pointer flip,
    the pruning). The loop is held only for the clones: a copy to pinned
    memory made on the training thread held it 105-130 ms for MNIST's 36
    MB on an H100 (``chip_smoke.py``'s ``train_extras``), as pinning is
    slow. A save point that finds the worker still busy is skipped
    (coalesced): ``skipped`` counts those, ``saved`` the saves the worker
    completed.
    A failed save raises at the next :meth:`poll`, :meth:`drain` or
    :meth:`finalize`. :meth:`finalize` drains the worker and shuts it
    down; the caller then saves the last state synchronously. One process
    alone: a multi-process run saves synchronously (rank 0 writing,
    :func:`save_checkpoint`), as the JAX multi-host run does."""

    def __init__(self, workdir: str):
        if process_count() > 1:
            raise ValueError("AsyncCheckpointWriter writes from one process; a multi-process "
                             "run saves with save_checkpoint")
        self._workdir = workdir
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="ckpt-async")
        self._inflight = None
        self._stream = None  # the side stream of the copies to the host
        self.saved = 0
        self.skipped = 0

    @property
    def busy(self) -> bool:
        """A save is still being written."""
        return self._inflight is not None and not self._inflight.done()

    def stage(
        self,
        state: TrainState,
        epoch: int,
        is_best: bool = False,
        extra: dict[str, Any] | None = None,
        keep_epochs: int = 0,
        generators: dict[str, torch.Generator] | None = None,
    ) -> bool:
        """Snapshot ``state`` for an overlapped save; False when skipped
        because the worker is still writing the previous one (whose
        failure, if it failed, raises here)."""
        if self.busy:
            self.skipped += 1
            return False
        self.poll()
        extra = dict(extra or {})
        tree, done, device = _snapshot(
            _to_tree(state, {"epoch": epoch, **extra}, generators or {}))
        if device is not None and self._stream is None:
            self._stream = torch.cuda.Stream(device=device)
        self._inflight = self._pool.submit(
            self._write, tree, done, self._stream, int(epoch), bool(is_best), extra,
            int(keep_epochs))
        return True

    def _write(self, tree, done, stream, epoch, is_best, extra, keep_epochs) -> None:
        tree = _to_host(tree, done, stream)
        _serialize_and_flip(self._workdir, tree, epoch, is_best, extra, keep_epochs)
        self.saved += 1

    def poll(self) -> None:
        """Raise a failed save now, without waiting for one in flight."""
        if self._inflight is not None and self._inflight.done():
            fut, self._inflight = self._inflight, None
            fut.result()

    def drain(self) -> None:
        """Wait for the save in flight (its failure raises here); the
        writer stays usable. Whoever reads the checkpoints next (a
        rollback's restore) drains first."""
        if self._inflight is not None:
            fut, self._inflight = self._inflight, None
            fut.result()

    def finalize(self) -> None:
        """Drain, then shut the worker down."""
        try:
            self.drain()
        finally:
            self._pool.shutdown(wait=True)


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

    The model's and the EMA shadow's parameters, and under gradient
    accumulation the running mean, are copied into their tensors; the
    optimizer's state is replaced (Adam's moments are made anew), so a CUDA
    graph runner is built after the load. The template keeps its own Adam
    form (``capturable`` and ``foreach`` on the card) and its own rate (a
    schedule's tensor on the card), whatever device saved the checkpoint.
    A template with gradient accumulation needs a checkpoint saved with
    the same ``accum_steps``; one without ignores a saved running mean. A checkpoint saved without an EMA shadow, loaded
    into a state that tracks one, starts the shadow from the parameters;
    a saved shadow that the state does not track is dropped. A sharded
    template (``state.layout``) takes its blocks of the whole tree. A
    missing or corrupt file raises.
    """
    ckpt_dir = os.path.join(os.path.abspath(workdir), "ckpt")
    path = _resolve_ckpt_path(ckpt_dir, which)
    if path is None and which == "best":
        path = _resolve_ckpt_path(ckpt_dir, "last")
    if path is None:
        raise FileNotFoundError(f"no checkpoint {which!r} under {ckpt_dir}")
    tree = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    state = template_state
    if state.layout is not None:
        tree = _per_param(state, tree, state.layout.shard)
    if state.acc_grads is not None:
        if tree.get("accum_steps") != state.accum_steps:
            raise ValueError(
                f"checkpoint {path} was saved with accum_steps "
                f"{tree.get('accum_steps', 1)}, not {state.accum_steps}")
        if tree["micro_step"] != int(tree["step"]) % state.accum_steps:
            raise ValueError(f"checkpoint {path}: micro-step {tree['micro_step']} "
                             f"is not step {tree['step']} mod {state.accum_steps}")
    with torch.no_grad():
        state.model.load_state_dict(tree["model"])
        if state.ema_model is not None:
            state.ema_model.load_state_dict(tree.get("ema_model", tree["model"]))
        state.device_step.copy_(tree["device_step"])
        if state.acc_grads is not None:
            for acc, saved in zip(state.acc_grads, tree["acc_grads"], strict=True):
                acc.copy_(saved)
    optimizer = tree["optimizer"]
    for saved, group in zip(optimizer["param_groups"], state.optimizer.param_groups):
        for key in ("capturable", "foreach", "lr"):
            saved[key] = group[key]
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
