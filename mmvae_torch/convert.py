"""Flax parameter tree -> PyTorch ``state_dict`` of the port's models.

Each expert's leaves map by name:

  * ``Dense_{i}`` in order onto its hidden ``layers.{i}`` and, for the last
    one, its ``head``; ``init_proj`` / ``out_proj`` onto the Linear of the
    same name. A Flax Dense ``kernel`` is ``(in, out)`` and is transposed
    into ``nn.Linear.weight`` ``(out, in)``.
  * ``Conv_{i}`` onto ``convs.{i}``: the kernel HWIO -> OIHW (the 4x4
    stride-2 stages, a ``space_to_depth`` encoder's 2x2 stage 0 and a
    ``"shuffle"`` decoder's 2x2 stages).
  * ``ConvTranspose_{i}`` onto ``deconvs.{i}``: Flax does not flip a
    transposed conv's kernel and PyTorch does, so the kernel is flipped in
    H and W, then HWIO -> ``(in, out, kh, kw)`` (the 4x4 stride-2 stages
    and a ``space_to_depth`` decoder's 2x2 last layer alike).
  * ``PipelineTrunk_0``'s ``kernels``, ``biases`` and ``alphas`` (the
    residual trunk of the deep configs) as they are onto ``trunk.*``.
  * ``Embed_0`` / ``embed`` ``(n_classes, dim)`` as it is onto
    ``embed.weight``; a bare ``embed`` array (the attribute bank's
    ``(A, 2, E)`` table, no ``{"embedding": ...}`` around it) onto the
    parameter ``embed``.
  * the GRU weights ``w_in``, ``u_rec``, ``b`` and the attribute banks'
    stacked ``w1``, ``b1``, ``w2``, ``b2`` as they are (bare arrays).

For the MNIST model that covers ``image_enc/Dense_{0,1,2}``,
``image_dec/Dense_{0,1,2}``, ``label_enc/{Embed_0,Dense_0,Dense_1}`` and
``label_dec/Dense_{0,1}``; for MultiMNIST ``image_enc/{Conv_{0..3},
Dense_{0,1}}``, ``image_dec/{Dense_{0,1}, ConvTranspose_{0..3}}``,
``text_enc/{Embed_0, w_in, u_rec, b, Dense_0}`` and ``text_dec/{embed,
init_proj, w_in, u_rec, b, out_proj}``; for CelebA ``image_enc/{Conv_{0..3},
Dense_{0,1}}``, ``image_dec/{Dense_{0,1}, ConvTranspose_{0..3}}``,
``attr_enc/{embed, w1, b1, w2, b2}`` and ``attr_dec/{w1, b1, w2, b2}``; for
CUB the leaf names of MultiMNIST's image and text experts, ``image_enc/
{Conv_{0..3}, Dense_{0,1}}``, ``image_dec/{Dense_{0,1}, ConvTranspose_{0..3}}``
(the last to 3 channels), ``text_enc/{Embed_0, w_in, u_rec, b, Dense_0}`` and
``text_dec/{embed, init_proj, w_in, u_rec, b, out_proj}``; for ``deep_mnist``
``image_enc/{Dense_0, PipelineTrunk_0, Dense_1}``, ``image_dec/{Dense_0,
PipelineTrunk_0, Dense_1}`` and MNIST's label experts; for ``deep_cub``
CUB's leaves with ``PipelineTrunk_0`` beside the image experts' ``Dense_*``.
A ``"shuffle"`` image decoder holds ``Conv_*`` in place of
``ConvTranspose_*`` (and a ``ConvTranspose_0`` last layer under
``space_to_depth``). A leaf of no such name raises.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["from_flax_params", "flax_axes"]

_LINEARS = ("init_proj", "out_proj")
_EMBEDS = ("Embed_0", "embed")
# Parameters stored as bare arrays, mapped as they are.
_BARE = ("w_in", "u_rec", "b", "w1", "b1", "w2", "b2")
# The stage-stacked residual trunk, its leaves as they are.
_TRUNK = "PipelineTrunk_0"


def _index(name: str) -> int:
    return int(name.rsplit("_", 1)[1])


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _numbered(layers, prefix: str) -> list[str]:
    return sorted(
        (k for k in layers if k.startswith(prefix) and k[len(prefix):].isdigit()),
        key=_index,
    )


def from_flax_params(
    params: Mapping[str, Mapping[str, Any]],
) -> dict[str, torch.Tensor]:
    """``params`` (the Flax tree under ``"params"``, arrays as numpy) ->
    a ``state_dict`` for ``load_state_dict``."""
    state: dict[str, torch.Tensor] = {}
    for expert, layers in params.items():
        dense = _numbered(layers, "Dense_")
        convs = _numbered(layers, "Conv_")
        deconvs = _numbered(layers, "ConvTranspose_")
        unknown = (
            set(layers) - set(dense) - set(convs) - set(deconvs)
            - set(_LINEARS) - set(_EMBEDS) - set(_BARE) - {_TRUNK}
        )
        if unknown:
            raise ValueError(f"{expert}: cannot map {sorted(unknown)}")
        for i, name in enumerate(dense):
            dst = f"{expert}.head" if i == len(dense) - 1 else f"{expert}.layers.{i}"
            state[f"{dst}.weight"] = _t(np.asarray(layers[name]["kernel"]).T)
            state[f"{dst}.bias"] = _t(layers[name]["bias"])
        for name in _LINEARS:
            if name in layers:
                state[f"{expert}.{name}.weight"] = _t(np.asarray(layers[name]["kernel"]).T)
                state[f"{expert}.{name}.bias"] = _t(layers[name]["bias"])
        for name in convs:
            kernel = np.asarray(layers[name]["kernel"]).transpose(3, 2, 0, 1)
            state[f"{expert}.convs.{_index(name)}.weight"] = _t(kernel)
            state[f"{expert}.convs.{_index(name)}.bias"] = _t(layers[name]["bias"])
        for name in deconvs:
            kernel = np.asarray(layers[name]["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
            state[f"{expert}.deconvs.{_index(name)}.weight"] = _t(kernel)
            state[f"{expert}.deconvs.{_index(name)}.bias"] = _t(layers[name]["bias"])
        for name in _EMBEDS:
            if name not in layers:
                continue
            if isinstance(layers[name], Mapping):
                state[f"{expert}.embed.weight"] = _t(layers[name]["embedding"])
            else:
                state[f"{expert}.embed"] = _t(layers[name])
        for name in _BARE:
            if name in layers:
                state[f"{expert}.{name}"] = _t(layers[name])
        for leaf, value in layers.get(_TRUNK, {}).items():
            state[f"{expert}.trunk.{leaf}"] = _t(value)
    return state


# The port's dim of each dim of the Flax kernel a layer's weight comes from:
# Dense (in, out) -> Linear (out, in); Conv HWIO -> OIHW; ConvTranspose
# HWIO -> (in, out, kh, kw), its H and W flipped.
_KERNEL_AXES = {nn.Linear: (1, 0), nn.Conv2d: (2, 3, 1, 0), nn.ConvTranspose2d: (2, 3, 0, 1)}


def flax_axes(module: nn.Module) -> dict[str, tuple[int, ...]]:
    """For each parameter of ``module`` (by name), the dims of the port's
    tensor that the Flax leaf's dims map onto, in Flax's order (the Flax
    shape is ``tuple(p.shape[a] for a in axes)``): a layer's weight as
    :func:`from_flax_params` transposes it, every other leaf as it is. A
    rule stated on Flax's shapes (the FSDP and TP layouts) reads them. A
    transposed conv's kernel is also flipped in H and W, so a block of its
    H or W holds other elements than Flax's block (no config's kernel is
    cut there: its channels are larger and divide)."""
    out = {}
    for mod_name, mod in module.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            axes = _KERNEL_AXES.get(type(mod)) if leaf == "weight" else None
            out[f"{mod_name}.{leaf}" if mod_name else leaf] = axes or tuple(range(p.dim()))
    return out
