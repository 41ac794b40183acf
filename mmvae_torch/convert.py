"""Flax parameter tree -> PyTorch ``state_dict`` of the port's models.

Each expert's Flax ``Dense_{i}`` layers map in order onto its hidden
``layers.{i}`` and, for the last one, its ``head``; a Flax Dense ``kernel``
is ``(in, out)`` and is transposed into ``nn.Linear.weight`` ``(out, in)``.
``Embed_0.embedding`` ``(n_classes, dim)`` maps as it is onto
``embed.weight``. For the MNIST model that covers ``image_enc/Dense_{0,1,2}``,
``image_dec/Dense_{0,1,2}``, ``label_enc/{Embed_0,Dense_0,Dense_1}`` and
``label_dec/Dense_{0,1}``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["from_flax_params"]


def _dense_index(name: str) -> int:
    return int(name.split("_")[1])


def from_flax_params(
    params: Mapping[str, Mapping[str, Any]],
) -> dict[str, torch.Tensor]:
    """``params`` (the Flax tree under ``"params"``, arrays as numpy) ->
    a ``state_dict`` for ``load_state_dict``."""
    state: dict[str, torch.Tensor] = {}
    for expert, layers in params.items():
        dense = sorted((k for k in layers if k.startswith("Dense_")), key=_dense_index)
        for i, name in enumerate(dense):
            dst = f"{expert}.head" if i == len(dense) - 1 else f"{expert}.layers.{i}"
            kernel = np.asarray(layers[name]["kernel"], dtype=np.float32)
            bias = np.asarray(layers[name]["bias"], dtype=np.float32)
            state[f"{dst}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T))
            state[f"{dst}.bias"] = torch.from_numpy(bias.copy())
        unknown = set(layers) - set(dense) - {"Embed_0"}
        if unknown:
            raise ValueError(f"{expert}: cannot map {sorted(unknown)}")
        if "Embed_0" in layers:
            emb = np.asarray(layers["Embed_0"]["embedding"], dtype=np.float32)
            state[f"{expert}.embed.weight"] = torch.from_numpy(emb.copy())
    return state
