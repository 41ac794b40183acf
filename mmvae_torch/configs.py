"""Experiment configs (port of ``mmvae_tpu/configs.py``).

The seven configs of the JAX package: ``mnist``, ``deep_mnist``,
``fashionmnist``, ``multimnist``, ``celeba``, ``cub`` and ``deep_cub``
(the two ``deep_*`` ones carry residual trunks in their image experts,
``models/pipeline.py``). The fields are those the inference slices, the
training slices, the training extras (gradient accumulation, the cosine
LR schedule, ``nan_rollback``, ``ckpt_async``, ``log_interval``), the
checkpoints (``ckpt_every``, ``keep_epoch_ckpts``) and the data layer
(``data_dtype``, ``eval_segment_steps``, ``data_kwargs``, ``data_backend``,
``grain_stream_steps`` and the shuffle modes) read, with the JAX defaults
(``mmvae_tpu/configs.py:30-175``); every config here trains with
``api.train``, under any of the four objectives; ``fsdp`` and ``tp`` are
JAX's parallel knobs (``mmvae_tpu/configs.py:146``, ``:165``), as is
``pp`` (``:169-173``). Eval pins
``n_random_subsets=0`` (``mmvae_tpu/train/step.py:1568``). A CUB model
takes the vocabulary of a mounted caption corpus where there is one
(:func:`cub_vocab_size`).
"""

from __future__ import annotations

import dataclasses
import inspect
import os
from typing import Any

import torch

from mmvae_torch.data.formats import cub_data_vocab
from mmvae_torch.data.synthetic import cub_vocab as synthetic_cub_vocab
from mmvae_torch.data.vocab import Vocab
from mmvae_torch.device import resolve_device
from mmvae_torch.models import (
    CelebAMVAE,
    CubMVAE,
    DeepCubMVAE,
    DeepMnistMVAE,
    FashionMnistMVAE,
    MnistMVAE,
    MultiMnistMVAE,
)

__all__ = [
    "ExperimentConfig",
    "CONFIGS",
    "get_config",
    "build_model",
    "cub_text_vocab",
    "cub_vocab_size",
]


@dataclasses.dataclass
class ExperimentConfig:
    """Hyperparameters of one experiment."""

    name: str
    dataset: str
    n_latents: int
    epochs: int = 20
    batch_size: int = 100
    learning_rate: float = 1e-3
    annealing_epochs: int = 10  # beta ramps 0 -> 1 over these epochs
    n_random_subsets: int = 0  # random modality-subset terms
    # "mvae" (PoE joint + subset ELBOs), "mmvae" (mixture of the unimodal
    # posteriors), "mopoe" (mixture of subset PoEs) or "mvtcae" (the joint
    # ELBO with its KL mixed with the cross-KLs to the unimodal posteriors).
    objective: str = "mvae"
    mvtcae_alpha: float = 0.9  # mvtcae's KL mix: (1 - a) to the prior, a cross
    member_prune: bool = True  # decode each key on its member terms only
    p_modality_drop: float = 0.0  # presence dropout per example and modality
    grad_clip: float = 0.0  # global-norm gradient clipping (0: off)
    ema_decay: float = 0.0  # EMA shadow of the parameters (0: off)
    # Gradient accumulation: the gradients of accum_steps micro-batches
    # averaged before one update (optax.MultiSteps; the effective batch is
    # accum_steps * batch_size).
    accum_steps: int = 1
    # "constant" (the config's rate) or "cosine" (a linear warmup from 0
    # over warmup_epochs, then a cosine decay to 0 over the run, counted in
    # updates).
    lr_schedule: str = "constant"
    warmup_epochs: int = 0
    # At most this many rollbacks a run to the last checkpoint when an
    # epoch's train loss or test ELBO is not finite (0: off; needs a
    # workdir).
    nan_rollback: int = 0
    train_size: int = 10000
    test_size: int = 2000
    # One train record every log_interval steps of an epoch in
    # metrics.jsonl.
    log_interval: int = 100
    # Checkpoints (with a workdir): every ckpt_every epochs and always at
    # the last; keep_epoch_ckpts > 0 also keeps that many newest
    # per-epoch snapshots (0: last and best only).
    ckpt_every: int = 1
    keep_epoch_ckpts: int = 0
    # Overlapped saves: the state snapshot on the card, copied to the host
    # and written by a worker thread while training goes on; a save point
    # that finds the writer busy is skipped; the last epoch saves
    # synchronously.
    ckpt_async: bool = False
    # Shard the parameters, Adam's moments and the EMA shadow over the data
    # mesh (ZeRO-3, parallel/fsdp.py; a multi-process run).
    fsdp: bool = False
    # Tensor parallelism: the ranks fold into a (data, model) mesh of
    # tp-rank model groups, column/row-parallel layers and sharded
    # attribute banks (parallel/tp.py); exclusive with fsdp.
    tp: int = 1
    # Pipeline parallelism: the ranks fold into a (data, pipe) mesh and the
    # model's stage-stacked trunks run the GPipe schedule (parallel/pp.py);
    # needs a trunk model (deep_mnist, deep_cub) with trunk_stages == pp,
    # exclusive with fsdp and tp.
    pp: int = 1
    # Reconstruct every modality from every subset posterior; cross
    # entries (modality m from a subset without m) weigh cross_recon_weight.
    cross_recon: bool = False
    cross_recon_weight: float = 1.0
    # The cross entries from detached decoders: their gradient reaches the
    # encoders only (needs cross_recon).
    cross_recon_stopgrad: bool = False
    # w * beta * KL(q(z|S) || sg(q(z|joint))) over the non-joint terms S.
    unimodal_align_weight: float = 0.0
    # The cycle term: the seq posterior rendered into the bernoulli
    # modalities, re-encoded, and the sequence read back (its CE weighs
    # cycle_weight); cycle_render_grad lets the render's decoders learn
    # from it; cycle_render_binarize: False (soft render), True (0/1
    # straight-through) or "both" (the CE of the two averaged).
    cycle_weight: float = 0.0
    cycle_render_grad: bool = False
    cycle_render_binarize: bool | str = False
    # The soft render's per-example pixel mean and std matched to the true
    # image's (needs cycle_weight).
    cycle_contrast_weight: float = 0.0
    # The storage dtype of the train split's float modalities: "float32",
    # "bfloat16" (half the bytes the device holds and each step reads) or
    # "uint8" (a quarter, quantized to the 1/255 grid: exact for 8-bit image
    # data and 0/1 labels; the step dequantizes it). The test split and the
    # model stay float32.
    data_dtype: str = "float32"
    # The eval split delivered to the device in segments of this many
    # batches (O(1 segment) device memory; the same result to the bit); 0
    # keeps the whole split on the device; -1 resolves to 0
    # (``api.resolve_eval_segments``).
    eval_segment_steps: int = -1
    # "device" (the train split on the device, each epoch's batches
    # gathered there) or "grain" (the split on the host; each epoch planned
    # and gathered there, in segments of grain_stream_steps batches (0: the
    # whole epoch) by a worker thread while the device trains the one
    # before; ``data/grain_pipeline.py``).
    data_backend: str = "device"
    grain_stream_steps: int = 0
    # Device backend: a true reshuffle every reshuffle_every epochs; the
    # epochs between "roll" the persisted order by a random offset or, under
    # "block", read its batches in a new order. shuffle_granularity = G > 1
    # permutes G-row groups after a random offset below G (exact rows when G
    # does not divide the split).
    reshuffle_every: int = 1
    shuffle_mode: str = "roll"
    shuffle_granularity: int = 1
    # Extra constructor arguments of the config's model.
    model_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    # Extra arguments of the data generators (``hw=128``), and of the
    # MultiMNIST composite; other mounted data must match the model as it is.
    data_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


CONFIGS: dict[str, ExperimentConfig] = {
    # MVAE on MNIST image+label: MLP encoders, PoE, full ELBO.
    "mnist": ExperimentConfig(
        name="mnist", dataset="mnist", n_latents=64, annealing_epochs=10,
    ),
    # MNIST with a residual trunk of 4 stages at width 256 in each image
    # expert (``mmvae_tpu/configs.py:194-197``).
    "deep_mnist": ExperimentConfig(
        name="deep_mnist", dataset="mnist", n_latents=64, annealing_epochs=10,
    ),
    # FashionMNIST image + label: conv image expert (32, 64) over 28x28
    # grayscale, deconv decoder, label expert (``mmvae_tpu/configs.py:199-201``).
    "fashionmnist": ExperimentConfig(
        name="fashionmnist", dataset="fashionmnist", n_latents=64,
    ),
    # MultiMNIST image + digit string: conv image expert over the 50x50
    # canvas, GRU text expert, a text expert limited to the first 128
    # latent dims (``mmvae_tpu/configs.py:223-234``).
    "multimnist": ExperimentConfig(
        name="multimnist", dataset="multimnist", n_latents=256,
        cross_recon=True, grad_clip=500.0, epochs=60, train_size=100000,
        cycle_weight=1.0, cycle_render_grad=True, cycle_render_binarize="both",
        model_kwargs={
            "conv_features": (32, 64, 128, 256),
            "lambda_text": 30.0,
            "text_hidden": 256,
            "text_latent_dims": 128,
        },
    ),
    # CelebA image + 18 attributes: conv image expert over 64x64 RGB, one
    # Gaussian expert per attribute, batch 64
    # (``mmvae_tpu/configs.py:236-239``).
    "celeba": ExperimentConfig(
        name="celeba", dataset="celeba", n_latents=100, batch_size=64,
        n_random_subsets=4, grad_clip=500.0,
    ),
    # CUB image + caption: conv image expert over 64x64 RGB, GRU caption
    # experts, batch 64, cross-recon and a low-weight cycle term with a
    # live soft render (``mmvae_tpu/configs.py:249-253``).
    "cub": ExperimentConfig(
        name="cub", dataset="cub", n_latents=256, batch_size=64,
        cross_recon=True, epochs=60, train_size=16000,
        cycle_weight=0.1, cycle_render_grad=True,
    ),
    # The cub experiment with a residual trunk of 4 stages at width 512 at
    # each image expert's bottleneck (``mmvae_tpu/configs.py:264-270``).
    "deep_cub": ExperimentConfig(
        name="deep_cub", dataset="cub", n_latents=256, batch_size=64,
        cross_recon=True, epochs=60, train_size=16000,
        cycle_weight=0.1, cycle_render_grad=True,
    ),
}

_MODEL_CLASSES = {
    "mnist": MnistMVAE,
    "fashionmnist": FashionMnistMVAE,
    "multimnist": MultiMnistMVAE,
    "celeba": CelebAMVAE,
    "cub": CubMVAE,
    "deep_mnist": DeepMnistMVAE,
    "deep_cub": DeepCubMVAE,
}


def get_config(name: str) -> ExperimentConfig:
    if name not in CONFIGS:
        raise ValueError(f"unknown config {name!r}; have {list(CONFIGS)}")
    return CONFIGS[name]


def build_model(
    config: ExperimentConfig | str,
    *,
    seed: int = 0,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
    tp_mesh=None,
    pp_mesh=None,
):
    """The config's model with seeded random weights, on ``device``, at the
    compute dtype ``dtype`` (``mmvae_tpu/configs.py:288``: float32 or
    bfloat16; the parameters are float32 at either).

    The weights are drawn on the CPU from a ``torch.Generator`` seeded with
    ``seed`` and then moved, so one seed gives the same weights on every
    device and at every dtype. ``tp_mesh`` (``parallel.make_mesh_2d``)
    builds the tensor-parallel variant (``mmvae_tpu/configs.py:289-314``):
    the same parameters, whole until ``parallel.tp_shard`` cuts them, and
    experts that run on the mesh's model group (``models/experts.py``).
    ``pp_mesh`` (``parallel.make_mesh_pp``) builds the pipelined variant
    (``:300-310``): the same parameters, whole until ``parallel.pp_shard``
    cuts them, and trunks that run the GPipe schedule; a config without
    trunks raises ``ValueError``.
    """
    if isinstance(config, str):
        config = get_config(config)
    device = resolve_device(device)
    kwargs = dict(config.model_kwargs)
    if config.dataset == "cub" and "vocab_size" not in kwargs:
        kwargs["vocab_size"] = cub_vocab_size()
    if tp_mesh is not None:
        kwargs["tp_mesh"] = tp_mesh
    if pp_mesh is not None:
        if "pp_mesh" not in inspect.signature(_MODEL_CLASSES[config.name]).parameters:
            raise ValueError(f"config {config.name!r} has no pipeline trunks; pp>1 needs a "
                             "trunk model (deep_cub or deep_mnist)")
        kwargs["pp_mesh"] = pp_mesh
    model = _MODEL_CLASSES[config.name](n_latents=config.n_latents, dtype=dtype, **kwargs)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def cub_text_vocab() -> Vocab:
    """The vocabulary of the CUB caption experts: a mounted corpus's
    (``data.formats.cub_data_vocab`` of ``$MMVAE_DATA_DIR/cub``: its
    ``vocab.json``, or the 2,000 most frequent words of its captions, 3
    reserved ids and ``<unk>``), else the synthetic one (23 ids), as
    ``mmvae_tpu/configs.py:318-333`` picks it."""
    data_dir = os.environ.get("MMVAE_DATA_DIR", "")
    cub_dir = os.path.join(data_dir, "cub") if data_dir else ""
    if cub_dir and os.path.isdir(cub_dir):
        vocab = cub_data_vocab(cub_dir)
        if vocab is not None:
            return vocab
    return synthetic_cub_vocab()


def cub_vocab_size() -> int:
    """The size of :func:`cub_text_vocab`."""
    return len(cub_text_vocab())
