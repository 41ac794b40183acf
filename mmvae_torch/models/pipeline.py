"""Deep residual-trunk MVAEs (port of ``mmvae_tpu/models/pipeline.py``).

:class:`PipelineTrunk` is a uniform-width residual MLP whose parameters
live in stage-stacked tensors (leading stage axis), with the Flax names
and shapes, so ``convert`` carries them across as they are.
:class:`DeepMnistMVAE` puts one in each MNIST image expert;
:class:`DeepCubMVAE` puts one at each CUB image expert's bottleneck (the
conv experts' ``trunk_stages`` hook, width ``fc_hidden`` = 512).

The JAX trunk runs as a ``lax.scan`` over the stage axis on one device,
or as a GPipe schedule over a ``(data, pipe)`` mesh (``pp_mesh``). The
port runs the scan as a loop over the leading axis, with no host sync, so
that a CUDA graph captures it; with ``pp_mesh`` it runs
``parallel.pp.pipeline_apply``, each rank its stage of the same stacked
parameters (``parallel.pp_shard`` cuts them), so a state or checkpoint of
one mode runs in the other.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from mmvae_torch.models.cub import CubMVAE
from mmvae_torch.models.experts import (
    ConvEncoder,
    DeconvDecoder,
    _hidden_layers,
    _layer,
    _run,
    _split_head,
    _tp_start,
    _whole,
    swish,
)
from mmvae_torch.models.mnist import MnistMVAE
from mmvae_torch.parallel.pp import pipeline_apply
from mmvae_torch.parallel.tp import plan_expert

__all__ = ["PipelineTrunk", "DeepMnistMVAE", "DeepCubMVAE"]


class PipelineTrunk(nn.Module):
    """Uniform-width residual MLP trunk with stage-stacked parameters.

    Per stage ``h + alpha_s * MLP_depth(h)`` (a swish after each layer),
    every width ``W``. Parameters as in Flax: ``kernels`` ``(S, depth, W,
    W)`` (input dim first, as a Flax Dense kernel), ``biases`` ``(S, depth,
    W)`` and, with ``rezero`` (the default), the residual gates ``alphas``
    ``(S,)``, which start at 0, so that a fresh trunk is the identity
    (``mmvae_tpu/models/pipeline.py:46-115``); ``rezero=False`` drops the
    gates (``h + MLP_depth(h)``). With ``pp_mesh``
    (``parallel.make_mesh_pp``, its pipe axis as long as the stages) the
    trunk runs the GPipe schedule over ``pp_n_micro`` microbatches
    (``parallel.pipeline_apply``), on the whole stacked parameters or on
    this rank's stage of them (``parallel.pp_shard``). At a compute
    ``dtype`` other than float32 the stacked kernels, biases and gates are
    cast to it once, outside the loop over the stages, and the trunk runs in
    it (``mmvae_tpu/models/pipeline.py:83-88``).
    """

    def __init__(self, n_stages: int, width: int, block_depth: int = 1, *,
                 rezero: bool = True, pp_mesh=None, pp_n_micro: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_stages, self.block_depth, self.rezero = n_stages, block_depth, rezero
        self.pp_mesh, self.pp_n_micro, self.dtype = pp_mesh, pp_n_micro, dtype
        self.kernels = nn.Parameter(torch.empty(n_stages, block_depth, width, width))
        self.biases = nn.Parameter(torch.zeros(n_stages, block_depth, width))
        self.alphas = nn.Parameter(torch.zeros(n_stages)) if rezero else None

    def _stage(self, p, h: torch.Tensor) -> torch.Tensor:
        """One stage on ``h``: ``p`` its kernels ``(depth, W, W)``, biases
        ``(depth, W)`` and, with ReZero, its gate."""
        y = h
        for i in range(self.block_depth):
            y = swish(y @ p[0][i] + p[1][i])
        return h + (p[2] * y if self.rezero else y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        params = [self.kernels.to(dt), self.biases.to(dt)]
        if self.rezero:
            params.append(self.alphas.to(dt))
        h = x.to(dt)
        if self.pp_mesh is not None:
            return pipeline_apply(self._stage, params, h, mesh=self.pp_mesh,
                                  n_micro=self.pp_n_micro)
        for s in range(self.n_stages):
            h = self._stage([t[s] for t in params], h)
        return h


class _TrunkEncoder(nn.Module):
    """Flat image -> dense to ``width`` (swish) -> trunk -> head ``(mu,
    logvar)``: Flax's ``Dense_0``, ``PipelineTrunk_0``, ``Dense_1``."""

    def __init__(self, in_features: int, n_latents: int, width: int, n_stages: int,
                 block_depth: int, rezero: bool = True, pp_mesh=None, pp_n_micro: int = 4,
                 dtype: torch.dtype = torch.float32, tp_mesh=None):
        super().__init__()
        self.n_latents = n_latents
        self.dtype = dtype
        self.layers = _hidden_layers(in_features, (width,))
        self.trunk = PipelineTrunk(n_stages, width, block_depth, rezero=rezero,
                                   pp_mesh=pp_mesh, pp_n_micro=pp_n_micro, dtype=dtype)
        self.head = nn.Linear(width, 2 * n_latents)
        self.tp = plan_expert(self, tp_mesh)

    def forward(self, x: torch.Tensor):
        _tp_start(self)
        h = _run(self.layers, x.reshape(x.shape[0], -1).to(self.dtype), self.dtype)
        out = _layer(self.head, self.trunk(_whole(self, h, -1)), self.dtype)
        return _split_head(_whole(self, out, -1).float(), self.n_latents)


class _TrunkDecoder(nn.Module):
    """Latent -> dense to ``width`` (swish) -> trunk -> logits of shape
    ``out_shape``: Flax's ``Dense_0``, ``PipelineTrunk_0``, ``Dense_1``."""

    def __init__(self, n_latents: int, out_shape: tuple[int, ...], width: int,
                 n_stages: int, block_depth: int, rezero: bool = True, pp_mesh=None,
                 pp_n_micro: int = 4, dtype: torch.dtype = torch.float32, tp_mesh=None):
        super().__init__()
        self.out_shape = tuple(out_shape)
        self.dtype = dtype
        self.layers = _hidden_layers(n_latents, (width,))
        self.trunk = PipelineTrunk(n_stages, width, block_depth, rezero=rezero,
                                   pp_mesh=pp_mesh, pp_n_micro=pp_n_micro, dtype=dtype)
        self.head = nn.Linear(width, math.prod(self.out_shape))
        self.tp = plan_expert(self, tp_mesh)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        _tp_start(self)
        h = self.trunk(_whole(self, _run(self.layers, z.to(self.dtype), self.dtype), -1))
        logits = _whole(self, _layer(self.head, h, self.dtype), -1).float()
        return logits.reshape((z.shape[0],) + self.out_shape)


class DeepMnistMVAE(MnistMVAE):
    """MNIST MVAE whose image experts carry a residual trunk of
    ``trunk_stages`` stages of ``trunk_depth`` layers at ``trunk_width``
    (the label experts, the PoE and the ELBO as in :class:`MnistMVAE`)."""

    def __init__(
        self,
        n_latents: int = 64,
        n_classes: int = 10,
        image_hw: tuple[int, int] = (28, 28),
        lambda_image: float = 1.0,
        lambda_label: float = 10.0,
        trunk_stages: int = 4,
        trunk_depth: int = 1,
        trunk_width: int = 256,
        trunk_rezero: bool = True,
        pp_mesh=None,
        pp_n_micro: int = 4,
        dtype: torch.dtype = torch.float32,
        tp_mesh=None,
    ):
        super().__init__(n_latents, n_classes, image_hw, lambda_image, lambda_label,
                         dtype=dtype, tp_mesh=tp_mesh)
        self.trunk_stages, self.pp_n_micro = trunk_stages, pp_n_micro
        trunk = dict(width=trunk_width, n_stages=trunk_stages, block_depth=trunk_depth,
                     rezero=trunk_rezero, pp_mesh=pp_mesh, pp_n_micro=pp_n_micro, dtype=dtype,
                     tp_mesh=tp_mesh)
        pixels = self.image_hw[0] * self.image_hw[1]
        self.image_enc = _TrunkEncoder(pixels, n_latents, **trunk)
        self.image_dec = _TrunkDecoder(n_latents, self.image_hw, **trunk)


class DeepCubMVAE(CubMVAE):
    """CUB images + captions MVAE with a residual trunk at each image
    expert's bottleneck (width ``fc_hidden`` = 512): the conv stacks, the
    caption GRUs, the PoE and the ELBO as in :class:`CubMVAE`
    (``mmvae_tpu/models/pipeline.py:197-250``)."""

    def __init__(
        self,
        n_latents: int = 128,
        vocab_size: int = 512,
        max_len: int = 32,
        image_hw: tuple[int, int] = (64, 64),
        lambda_image: float = 1.0,
        lambda_text: float = 5.0,
        conv_features: tuple[int, ...] = (32, 64, 128, 256),
        upsample_mode: str = "deconv",
        trunk_stages: int = 4,
        trunk_depth: int = 1,
        trunk_rezero: bool = True,
        pp_mesh=None,
        pp_n_micro: int = 4,
        dtype: torch.dtype = torch.float32,
        tp_mesh=None,
    ):
        super().__init__(n_latents, vocab_size, max_len, image_hw, lambda_image, lambda_text,
                         conv_features, upsample_mode, dtype=dtype, tp_mesh=tp_mesh)
        self.trunk_stages, self.pp_n_micro = trunk_stages, pp_n_micro
        trunk = dict(trunk_stages=trunk_stages, trunk_depth=trunk_depth,
                     trunk_rezero=trunk_rezero, pp_mesh=pp_mesh, pp_n_micro=pp_n_micro,
                     dtype=dtype, tp_mesh=tp_mesh)
        self.image_enc = ConvEncoder(n_latents, self.image_hw, conv_features, channels=3,
                                     **trunk)
        self.image_dec = DeconvDecoder(
            n_latents, self.image_hw, features=tuple(reversed(conv_features)),
            upsample_mode=upsample_mode, channels=3, **trunk)
