"""Serving export: the conditioned generation program as one artifact.

Port of ``mmvae_tpu/serving.py``. The whole of ``api.generate`` -- encode
the observed modalities, fuse them with the prior under the config's
objective (``core.fuse_observed_z``), take z as the posterior mean or a
draw, decode EVERY modality, postprocess (sigmoid, argmax, the tokens
decoded at a traced temperature) -- is one ``nn.Module``
(:func:`make_generate_fn`), exported once with ``torch.export`` with the
weights as its parameters and saved to a single file. A server loads the
file and calls it (:func:`load_generate`); it needs no model code and no
checkpoint.

The program's inputs: a batch dict shaped like ``model.dummy_batch(n)``,
an ``(n, n_modalities)`` f32 presence mask (the observed modalities), an
int64 seed (``(n,)`` per row, or 0-d) and a 0-d f32 temperature; the last
two are inputs, so one program serves every seed and temperature. The
batch is static or, with ``batch_size="dynamic"``, a symbolic leading dim
of every input (``torch.export.Dim``).

The kernels are in the graph: under the ``"auto"`` and ``"kernel"``
backends the exported program holds ``mmvae::poe_kl`` (the fusion of every
objective) and, for the RGB image encoders of CelebA and CUB,
``mmvae::conv4x4s2_swish`` (``ops/library.py``), whatever device it was
exported on; on the card they launch the hand-written kernels, on the CPU
they run their plain versions. An export under the ``"torch"`` backend
holds the plain ops, the on-card reference. The random draws are Philox
streams keyed per row (``core/rowrng.py``), so in ``per_row`` mode row i's
output is a function of row i's data, presence and seed and of the
temperature alone, which is what makes the host's request coalescing
exact (``serve.py``).

File format: the magic ``MMVAEPT1``, a ``<I`` header length, the JSON
header (the interface: modalities, batch shapes, batch size, seed mode,
objective, config name, the device it was exported on), then the blob
``torch.export.save`` writes. :func:`read_meta` reads the header without
deserializing the program.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Any

import numpy as np
import torch
from torch import nn

from mmvae_torch import ops  # noqa: F401 -- registers the mmvae ops the artifacts hold
from mmvae_torch.core import fuse_observed_z
from mmvae_torch.core.rowrng import STREAM_COMPONENT, STREAM_TEXT, STREAM_Z, RowRng
from mmvae_torch.device import resolve_device
from mmvae_torch.models.text import SeqDecoder

__all__ = [
    "PLATFORMS",
    "make_generate_fn",
    "export_generate",
    "read_meta",
    "load_generate",
]

_MAGIC = b"MMVAEPT1"
# The platforms an artifact serves (``"gpu"`` names the card too).
PLATFORMS = ("cuda", "cpu")
_PLATFORM_NAMES = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


class _GenerateProgram(nn.Module):
    """``forward(batch, presence, seed, temperature) -> outputs``: the math
    of :func:`make_generate_fn`."""

    def __init__(self, model: nn.Module, objective: str, sample_z: bool, per_row_seed: bool):
        super().__init__()
        self.model = model
        self.objective = objective
        self.sample_z = sample_z
        self.per_row_seed = per_row_seed

    def _draws(self, n_latents: int) -> dict[int, int]:
        """The words of each stream the program draws: z's normals and the
        mixture's component when it samples z, each sequence decoder's
        Gumbel noise (a draw per step and token)."""
        sizes = {}
        if self.sample_z:
            sizes[STREAM_Z] = 2 * -(-n_latents // 2)
            sizes[STREAM_COMPONENT] = 1
        for m in self.model.modules():
            if isinstance(m, SeqDecoder):
                sizes[STREAM_TEXT] = m.max_len * m.out_proj.out_features
        return sizes

    def forward(self, batch: dict[str, torch.Tensor], presence: torch.Tensor,
                seed: torch.Tensor, temperature: torch.Tensor) -> dict[str, torch.Tensor]:
        from mmvae_torch.api import _postprocess

        mu_e, lv_e = self.model.encode(batch)
        rng = RowRng.from_seed(seed, presence.shape[0], self.per_row_seed)
        rng.prefetch(self._draws(mu_e.shape[-1]))
        eps = uniform = None
        if self.sample_z:
            eps = rng.normal(STREAM_Z, mu_e.shape[-1])
            uniform = rng.uniform(STREAM_COMPONENT, 1)[:, 0]
        z = fuse_observed_z(mu_e, lv_e, presence, self.objective, sample=self.sample_z,
                            eps=eps, uniform=uniform)
        return _postprocess(self.model, self.model.decode(z), z, temperature, None, rng)


def make_generate_fn(
    model: nn.Module,
    *,
    sample_z: bool = False,
    per_row_seed: bool = False,
    objective: str = "mvae",
) -> nn.Module:
    """The generation program of ``model``'s weights: a module whose
    ``forward(batch, presence, seed, temperature)`` gives ``{modality:
    output}``.

    ``api.generate``'s math: the objective's posterior over the observed
    experts (``core.fuse_observed_z``: the PoE with the prior for mvae and
    mvtcae through ``ops.poe_kl``, the mixture over the observed set for
    mmvae and mopoe), z its mean or, with ``sample_z``, a draw; every
    decoder; bernoulli modalities as sigmoid probabilities, categorical ones
    as argmax indices, sequence modalities as tokens decoded at the 0-d
    ``temperature`` (argmax where it is <= 0).

    The draws (z's noise, the mixture's component, the tokens' Gumbel
    noise) come from Philox streams keyed by ``seed``
    (``core/rowrng.py``). ``per_row_seed=True`` takes ``seed`` as an
    ``(n,)`` int64 tensor, a key per row, so row i's output is a function
    of row i's data, presence and seed and of the temperature alone:
    independent of its batch position and of every other row (no vmap is
    needed: the per-row key gives it by construction). Otherwise ``seed``
    is 0-d, the rows share its key and each row's index is part of the
    counter.
    """
    return _GenerateProgram(model, objective, sample_z, per_row_seed)


def _platforms(platforms) -> list[str]:
    names = []
    for p in platforms:
        if p not in _PLATFORM_NAMES:
            raise ValueError(
                f"platform {p!r} cannot be served by mmvae_torch; have {sorted(_PLATFORM_NAMES)}")
        if _PLATFORM_NAMES[p] not in names:
            names.append(_PLATFORM_NAMES[p])
    return names


def export_generate(
    config,
    out_path: str,
    *,
    batch_size: int | str = 8,
    model: nn.Module | None = None,
    state_dict: dict[str, torch.Tensor] | None = None,
    workdir: str | None = None,
    which: str = "best",
    device: torch.device | str | None = None,
    sample_z: bool = False,
    platforms=PLATFORMS,
    dtype: torch.dtype | None = None,
    seed_mode: str = "per_row",
) -> str:
    """Export the generation program of ``config`` to ``out_path``; returns
    ``out_path``.

    The weights come as in ``api.generate``: ``model``, ``state_dict``, or
    ``workdir``'s checkpoint ``which`` (the EMA weights where tracked). The
    program is traced on ``device`` (the card by default) with
    ``torch.export.export``, the weights as its parameters.

    ``batch_size`` is an int, or ``"dynamic"``: a symbolic leading dim of
    every input, so one artifact serves any request size with no padding.
    ``seed_mode``: ``"per_row"`` (the default) makes the seed input an
    ``(n,)`` array and each row independent of its batch position, which the
    host's request coalescing relies on; ``"scalar"`` takes one seed that
    the rows share. ``platforms`` names where the artifact may be served
    (``"cuda"`` or ``"gpu"``, and ``"cpu"``); any other raises. ``dtype`` is
    the experts' compute dtype, as in ``api.generate`` (None: the model's,
    float32 for one built here; ``mmvae_tpu/serving.py:122``; a given
    model keeps its own after the call): at bfloat16
    the graph holds the casts to bf16 and back, and
    ``mmvae::conv4x4s2_swish`` on bf16 operands; the inputs and outputs
    keep their types.
    """
    from mmvae_torch import api

    if seed_mode not in ("per_row", "scalar"):
        raise ValueError(f"seed_mode must be per_row|scalar: {seed_mode}")
    platforms = _platforms(platforms)
    config, model, device = api._resolve(config, model, state_dict, device, workdir, which)
    per_row = seed_mode == "per_row"
    program = make_generate_fn(model, sample_z=sample_z, per_row_seed=per_row,
                               objective=config.objective).eval()
    dynamic = batch_size == "dynamic"
    concrete = 2 if dynamic else int(batch_size)
    batch = model.dummy_batch(concrete)
    args = (
        batch,
        torch.zeros((concrete, model.n_modalities), device=device),
        torch.zeros((concrete,) if per_row else (), dtype=torch.int64, device=device),
        torch.ones((), device=device),
    )
    dynamic_shapes = None
    if dynamic:
        n = torch.export.Dim("batch", min=1)
        dynamic_shapes = ({k: {0: n} for k in batch}, {0: n}, {0: n} if per_row else None, None)
    with torch.no_grad(), model.at_dtype(dtype):
        exported = torch.export.export(program, args, dynamic_shapes=dynamic_shapes)
    blob = io.BytesIO()
    torch.export.save(exported, blob)
    header = json.dumps({
        "config": config.name,
        "batch_size": "dynamic" if dynamic else int(batch_size),
        "sample_z": sample_z,
        # The posterior family baked into the program: the PoE ("mvae",
        # "mvtcae") or a mixture ("mmvae", "mopoe"); informational.
        "objective": config.objective,
        "seed_mode": seed_mode,
        "platforms": platforms,
        "device": device.type,
        "torch": torch.__version__,
        "modalities": [s.name for s in model.specs()],
        # Batch key -> the experts it feeds (CelebA's stacked "attrs"
        # carries the 18 attr_i experts): a host sets the presence mask
        # with no model code.
        "batch_modalities": model.batch_modalities(),
        # A dynamic artifact's leading dim is None.
        "batch_shapes": {
            k: [[None if dynamic else concrete, *v.shape[1:]], str(v.dtype).removeprefix("torch.")]
            for k, v in batch.items()
        },
    }).encode()
    with open(out_path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(blob.getbuffer())
    return out_path


def _read(f, path: str) -> dict:
    if f.read(len(_MAGIC)) != _MAGIC:
        raise ValueError(f"{path}: not an mmvae_torch export artifact")
    (length,) = struct.unpack("<I", f.read(4))
    return json.loads(f.read(length).decode())


def read_meta(path: str) -> dict:
    """The JSON header of the artifact at ``path``, without deserializing
    the program."""
    with open(path, "rb") as f:
        return _read(f, path)


def _load_program(path: str, device: torch.device):
    """``(meta, exported)``: the header and the ``torch.export.ExportedProgram``
    of the artifact at ``path``, moved to ``device`` with
    ``torch.export.passes.move_to_device_pass``."""
    from torch.export.passes import move_to_device_pass

    with open(path, "rb") as f:
        meta = _read(f, path)
        blob = io.BytesIO(f.read())
    if device.type not in meta["platforms"]:
        raise ValueError(f"{path} serves {meta['platforms']}, not {device.type}")
    exported = torch.export.load(blob)
    if device.type != meta["device"] or device.type == "cuda":
        exported = move_to_device_pass(exported, device)
    return meta, exported


def load_generate(path: str, device: torch.device | str | None = None):
    """Load an exported artifact: ``(meta, call)``.

    The program is loaded with ``torch.export.load`` and moved to
    ``device`` (the card by default; on a machine with no card that raises
    unless ``device="cpu"`` is given) with
    ``torch.export.passes.move_to_device_pass``. ``meta`` is the JSON
    header.

    ``call(batch, presence, seed=0, temperature=1.0)`` takes arrays or
    tensors and returns ``{modality: tensor}`` on ``device``. In
    ``per_row`` mode ``seed`` may be a scalar, expanded to ``seed +
    arange(n)`` (each row distinct and deterministic), or an ``(n,)``
    array of row seeds. ``call.exported`` is the loaded program and
    ``call.device`` its device.
    """
    device = resolve_device(device)
    meta, exported = _load_program(path, device)
    program = exported.module()
    per_row = meta["seed_mode"] == "per_row"
    dtypes = {k: getattr(torch, v[1]) for k, v in meta["batch_shapes"].items()}

    def call(batch: dict[str, Any], presence, seed=0, temperature=1.0) -> dict[str, torch.Tensor]:
        batch = {k: torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v),
                                    dtype=dtypes[k], device=device) for k, v in batch.items()}
        presence = torch.as_tensor(presence, dtype=torch.float32, device=device)
        seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
        if per_row and seed.dim() == 0:
            seed = seed + torch.arange(presence.shape[0], dtype=torch.int64, device=device)
        temperature = torch.as_tensor(temperature, dtype=torch.float32, device=device)
        with torch.no_grad():
            return program(batch, presence, seed, temperature)

    call.exported = exported
    call.device = device
    return meta, call
