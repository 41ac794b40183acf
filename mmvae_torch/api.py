"""User-facing entry points of the inference slice (port of ``mmvae_tpu/api.py``).

  * :func:`eval_elbo` -- mean multi-term ELBO over a split (``api.py:1013``);
  * :func:`generate` -- cross-modal generation from any observed subset
    (``api.py:1504``);
  * :func:`sample` -- unconditional samples (``api.py:1474``).

Every entry point runs on ``device``, which defaults to the card
(``torch.device("cuda")``) and raises when there is none; pass
``device="cpu"`` to run on the CPU. Weights come from a ``model`` the
caller built (``configs.build_model``, or ``convert.from_flax_params``
loaded into it) or a ``state_dict``; checkpoint loading and training are
not ported yet.
"""

from __future__ import annotations

from typing import Any

import torch

from mmvae_torch.configs import ExperimentConfig, build_model, get_config
from mmvae_torch.core import fuse_observed_z
from mmvae_torch.data import Dataset, load_dataset, stacked_epoch_padded
from mmvae_torch.device import resolve_device
from mmvae_torch.train import make_eval_runner

__all__ = ["eval_elbo", "generate", "sample"]


def _resolve(config, model, state_dict, device):
    if isinstance(config, str):
        config = get_config(config)
    device = resolve_device(device)
    if model is None:
        if state_dict is None:
            raise ValueError("need a model or a state_dict")
        model = build_model(config, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return config, model.to(device), device


def eval_elbo(
    config: str | ExperimentConfig,
    *,
    model=None,
    state_dict: dict[str, torch.Tensor] | None = None,
    dataset: Dataset | None = None,
    batch_size: int | None = None,
    device: torch.device | str | None = None,
) -> float:
    """Mean multi-term ELBO over a split, beta = 1 and z = posterior mean.

    ``dataset`` defaults to the config's synthetic test split. The split
    is padded to whole batches (wrapping to its front); the validity mask
    is the presence mask, so pad rows contribute 0 and the result is
    ``sum(batch losses) * bs / size``.
    """
    config, model, device = _resolve(config, model, state_dict, device)
    if dataset is None:
        dataset = load_dataset(config.dataset, "test", n=config.test_size)
    batch_size = min(batch_size or config.batch_size, dataset.size)
    batches, valid = stacked_epoch_padded(dataset, batch_size)
    stacked = {k: torch.as_tensor(v, device=device) for k, v in batches.items()}
    stacked["presence"] = (
        torch.as_tensor(valid, device=device)[..., None]
        .expand(-1, -1, model.n_modalities)
    )
    metrics = make_eval_runner(model, config.objective)(stacked)
    return float(metrics["loss"].sum()) * batch_size / dataset.size


def _postprocess(model, recons: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Decode dict -> user-facing tensors: probabilities for bernoulli
    modalities, class indices for categorical ones."""
    kinds = model.decode_kinds()
    out = {}
    for key, value in recons.items():
        if kinds[key] == "bernoulli":
            out[key] = torch.sigmoid(value)
        elif kinds[key] == "categorical":
            out[key] = torch.argmax(value, dim=-1)
        else:
            raise NotImplementedError(
                f"generating {kinds[key]!r} modalities is not yet ported"
            )
    return out


@torch.no_grad()
def generate(
    config: str | ExperimentConfig,
    condition: dict[str, Any],
    *,
    n: int | None = None,
    model=None,
    state_dict: dict[str, torch.Tensor] | None = None,
    device: torch.device | str | None = None,
    sample_z: bool = False,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """Cross-modal generation from any modality subset.

    ``condition`` maps modality names to observed values (empty: prior
    sampling). The observed experts are fused with the prior; z is the
    posterior mean, or a draw from ``generator`` (on ``device``) when
    ``sample_z``; ALL modalities are decoded.
    """
    config, model, device = _resolve(config, model, state_dict, device)
    names = [s.name for s in model.specs()]
    if n is None:
        n = len(next(iter(condition.values()))) if condition else 1
    batch = model.dummy_batch(n)
    presence = torch.zeros((n, len(names)), device=device)
    for key, value in condition.items():
        if key not in batch:
            raise ValueError(f"unknown modality {key!r}; have {list(batch)}")
        batch[key] = torch.as_tensor(value, dtype=batch[key].dtype, device=device)
        presence[:, names.index(key)] = 1.0
    mu_e, lv_e = model.encode(batch)
    z = fuse_observed_z(
        mu_e, lv_e, presence, config.objective, sample=sample_z,
        generator=generator,
    )
    return _postprocess(model, model.decode(z))


def sample(
    config: str | ExperimentConfig,
    n: int = 64,
    *,
    model=None,
    state_dict: dict[str, torch.Tensor] | None = None,
    device: torch.device | str | None = None,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """Unconditional samples: z ~ N(0, I) decoded into every modality."""
    return generate(
        config, {}, n=n, model=model, state_dict=state_dict, device=device,
        sample_z=True, generator=generator,
    )
