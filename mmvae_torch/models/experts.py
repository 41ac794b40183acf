"""Per-modality encoder/decoder experts (port of ``mmvae_tpu/models/experts.py:40-484``).

Encoders return ``(mu, logvar)``; decoders return logits. Each expert's
dense part is a stack of ``nn.Linear`` layers with swish activations
(``layers``) and a last ``head``; ``mmvae_torch.convert`` maps Flax's
``Dense_{i}`` onto them in order, and ``Conv_{i}`` / ``ConvTranspose_{i}``
onto ``convs.{i}`` / ``deconvs.{i}``. Encoder heads are ONE ``Linear`` to
``2 * n_latents`` that is split ``[:L]`` / ``[L:]``, as in the JAX experts.

The conv experts take and give images in the JAX package's layout:
grayscale ``(B, H, W)`` or, with ``channels > 1``, NHWC ``(B, H, W, C)``;
inside, the convolutions run NCHW. The attribute banks keep their
parameters stacked along a leading attribute axis in the Flax layout and
contract them with ``einsum``.

``dtype`` is the compute dtype, as in the JAX experts: the parameters stay
float32, and at bfloat16 each layer casts its input, its weight and its
bias to bfloat16, takes the product in bfloat16 and adds the bias after
it as an op of its own (Flax's ``promote_dtype``, then ``dot_general`` or
``conv_general_dilated``, then ``+ bias``; :func:`_layer`). Every head
that feeds a loss casts back to float32 where the JAX expert does, so the
losses see float32 ``mu``, ``logvar`` and logits at either dtype.

``tp_mesh`` (a ``(data, model)`` mesh, ``parallel.make_mesh_2d``) builds an
expert that runs tensor-parallel over the mesh's model group on the
parameters ``parallel.tp_shard`` leaves the rank (``mmvae_tpu/models/
experts.py:45-90``, where GSPMD runs the same layout): each Dense and conv
layer is column-parallel, row-parallel or replicated by
``parallel.tp.expert_kinds`` (``tp_kind``), and :func:`_layer` moves the
activation between its whole and its channel blocks with the
``parallel.tp`` collectives as the kinds require (a column-parallel layer's
input enters by ``copy_in``; a row-parallel layer's partial product is
summed by ``reduce_out`` before its bias). Where an op reads every channel
(the flatten between the conv and the Dense chain, a trunk, a
depth-to-space, the expert's output) the activation is made whole first
(:func:`_whole`). Stage 0 of an RGB encoder runs K4 on the rank's 32 / tp
channels. An attribute bank whose attributes divide over the group runs
the rank's attributes and gathers the outputs. Without ``tp_mesh`` nothing
changes.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mmvae_torch import ops
from mmvae_torch.ops.kernels import same_pad
from mmvae_torch.parallel.tp import TPGroup, copy_in, gather_out, is_bank, plan_expert, reduce_out

__all__ = [
    "swish",
    "MLPEncoder",
    "MLPDecoder",
    "LabelEncoder",
    "LabelDecoder",
    "ConvEncoder",
    "DeconvDecoder",
    "AttributeEncoderBank",
    "AttributeDecoderBank",
]


def swish(x: torch.Tensor) -> torch.Tensor:
    """Swish/SiLU, ``x * sigmoid(x)``."""
    return x * torch.sigmoid(x)


def _hidden_layers(in_features: int, hidden: Sequence[int]) -> nn.ModuleList:
    widths = (in_features, *hidden)
    return nn.ModuleList(
        nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])
    )


def _product(layer: nn.Module, h: torch.Tensor, w: torch.Tensor,
             b: torch.Tensor | None = None) -> torch.Tensor:
    """``layer``'s op on ``h`` with the weight ``w`` and the bias ``b``."""
    if isinstance(layer, nn.Linear):
        return F.linear(h, w, b)
    if isinstance(layer, nn.Conv2d):
        return F.conv2d(h, w, b, layer.stride, layer.padding)
    return F.conv_transpose2d(h, w, b, layer.stride, layer.padding)


def _add_bias(layer: nn.Module, y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return y + (b if isinstance(layer, nn.Linear) else b[:, None, None])


def _layer(layer: nn.Module, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` (an ``nn.Linear``, ``nn.Conv2d`` or ``nn.ConvTranspose2d``)
    on ``h`` at the compute dtype: at float32 the layer as it is; at another,
    ``h``, the weight and the bias cast to it and the bias added after the
    product (a fused bias would be added before the product's one rounding,
    which is not Flax's order). A layer of a tensor-parallel expert runs
    by its ``tp_kind`` (:func:`_tp_layer`)."""
    if getattr(layer, "tp_kind", None) is not None:
        return _tp_layer(layer, h, dtype)
    if dtype == torch.float32:
        return layer(h)
    return _add_bias(layer, _product(layer, h.to(dtype), layer.weight.to(dtype)),
                     layer.bias.to(dtype))


def _tp_layer(layer: nn.Module, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A layer on the rank's parameters: ``"col"`` takes the whole input
    (``copy_in``) and gives the rank's block of the output channels;
    ``"row"`` takes the rank's block of the input channels and sums the
    group's partial products (``reduce_out``), then adds the bias;
    ``"rep"`` computes the whole. The expert's ``TPGroup`` tracks whether
    the activation is in blocks, and gathers or splits it on the way in."""
    tp: TPGroup = layer.tp_group
    kind, dim = layer.tp_kind, -1 if isinstance(layer, nn.Linear) else 1
    if kind == "row":
        h = tp.sharded_in(h, dim)
    else:
        h = tp.replicated(h, dim)
        if kind == "col":
            h = copy_in(h, tp)
    w, b = layer.weight, layer.bias
    if dtype != torch.float32:
        h, w, b = h.to(dtype), w.to(dtype), b.to(dtype)
    if kind == "row":
        y = _add_bias(layer, reduce_out(_product(layer, h, w), tp), b)
    elif dtype == torch.float32:
        y = _product(layer, h, w, b)
    else:
        y = _add_bias(layer, _product(layer, h, w), b)
    tp.sharded = kind == "col"
    return y


def _tp_start(expert: nn.Module) -> None:
    """A forward of a tensor-parallel expert starts on a whole input."""
    if expert.tp is not None:
        expert.tp.sharded = False


def _whole(expert: nn.Module, h: torch.Tensor, dim: int) -> torch.Tensor:
    """``h`` whole along its channel dim ``dim``: gathered where a
    tensor-parallel expert holds it in blocks, else as it is."""
    return h if expert.tp is None else expert.tp.replicated(h, dim)


def _run(layers: nn.ModuleList, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    for layer in layers:
        h = swish(_layer(layer, h, dtype))
    return h


def _embed(embed: nn.Embedding, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows of ``embed``'s table cast to ``dtype``, as Flax's
    ``Embed(dtype=)`` casts the table and then takes its rows."""
    if dtype == torch.float32:
        return embed(ids.long())
    return F.embedding(ids.long(), embed.weight.to(dtype))


def _split_head(out: torch.Tensor, n_latents: int):
    return out[:, :n_latents], out[:, n_latents:]


class MLPEncoder(nn.Module):
    """Flat-input MLP encoder -> ``(mu, logvar)``; the MNIST image expert."""

    def __init__(
        self, in_features: int, n_latents: int, hidden: Sequence[int] = (512, 512),
        dtype: torch.dtype = torch.float32, tp_mesh=None,
    ):
        super().__init__()
        self.n_latents = n_latents
        self.dtype = dtype
        self.layers = _hidden_layers(in_features, hidden)
        self.head = nn.Linear(hidden[-1], 2 * n_latents)
        self.tp = plan_expert(self, tp_mesh)

    def forward(self, x: torch.Tensor):
        _tp_start(self)
        h = _run(self.layers, x.reshape(x.shape[0], -1).to(self.dtype), self.dtype)
        out = _whole(self, _layer(self.head, h, self.dtype), -1)
        return _split_head(out.float(), self.n_latents)


class MLPDecoder(nn.Module):
    """Latent -> logits of shape ``out_shape``; the MNIST image expert."""

    def __init__(
        self,
        n_latents: int,
        out_shape: tuple[int, ...],
        hidden: Sequence[int] = (512, 512),
        dtype: torch.dtype = torch.float32,
        tp_mesh=None,
    ):
        super().__init__()
        self.out_shape = tuple(out_shape)
        self.dtype = dtype
        self.layers = _hidden_layers(n_latents, hidden)
        self.head = nn.Linear(hidden[-1], math.prod(self.out_shape))
        self.tp = plan_expert(self, tp_mesh)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        _tp_start(self)
        h = _run(self.layers, z.to(self.dtype), self.dtype)
        logits = _whole(self, _layer(self.head, h, self.dtype), -1).float()
        return logits.reshape((z.shape[0],) + self.out_shape)


class LabelEncoder(nn.Module):
    """Class-label expert: embed -> MLP -> ``(mu, logvar)``."""

    def __init__(
        self,
        n_latents: int,
        n_classes: int,
        embed_dim: int = 512,
        hidden: Sequence[int] = (512,),
        dtype: torch.dtype = torch.float32,
        tp_mesh=None,
    ):
        super().__init__()
        self.n_latents = n_latents
        self.dtype = dtype
        self.embed = nn.Embedding(n_classes, embed_dim)
        self.layers = _hidden_layers(embed_dim, hidden)
        self.head = nn.Linear(hidden[-1], 2 * n_latents)
        self.tp = plan_expert(self, tp_mesh)

    def forward(self, y: torch.Tensor):
        _tp_start(self)
        h = _run(self.layers, _embed(self.embed, y, self.dtype), self.dtype)
        out = _whole(self, _layer(self.head, h, self.dtype), -1)
        return _split_head(out.float(), self.n_latents)


class LabelDecoder(nn.Module):
    """Latent -> class logits."""

    def __init__(
        self, n_latents: int, n_classes: int, hidden: Sequence[int] = (512,),
        dtype: torch.dtype = torch.float32, tp_mesh=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.layers = _hidden_layers(n_latents, hidden)
        self.head = nn.Linear(hidden[-1], n_classes)
        self.tp = plan_expert(self, tp_mesh)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        _tp_start(self)
        h = _run(self.layers, z.to(self.dtype), self.dtype)
        return _whole(self, _layer(self.head, h, self.dtype), -1).float()


def _conv_out(d: int, n_stages: int) -> int:
    for _ in range(n_stages):
        d = -(-d // 2)
    return d


def _space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """``(B, H, W, C)`` -> ``(B, H/r, W/r, r*r*C)``: each r x r patch folded
    into the channels, channel ``(ry * r + rx) * C + c`` (C minor), as
    ``mmvae_tpu/models/experts.py:245-252`` folds it."""
    b, hh, ww, c = x.shape
    x = x.reshape(b, hh // r, r, ww // r, r, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hh // r, ww // r, r * r * c)


def _depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of :func:`_space_to_depth`: ``(B, H, W, r*r*C)`` -> ``(B,
    H*r, W*r, C)``, reading channel ``(ry * r + rx) * C + c``. (
    ``F.pixel_shuffle`` reads ``c * r*r + ry * r + rx``, another order.)"""
    b, hh, ww, c = x.shape
    x = x.reshape(b, hh, ww, r, r, c // (r * r))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hh * r, ww * r, c // (r * r))


def _shuffle_up(h: torch.Tensor, r: int) -> torch.Tensor:
    """:func:`_depth_to_space` of an NCHW activation, giving NCHW."""
    return _depth_to_space(h.permute(0, 2, 3, 1), r).permute(0, 3, 1, 2)


def _conv2x2(conv: nn.Conv2d, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax's ``Conv((2, 2), (1, 1), "SAME")``: padded (0, 1), so output i
    reads input rows i and i + 1."""
    return _layer(conv, F.pad(h, (0, 1, 0, 1)), dtype)


def _deconv2x2(deconv: nn.ConvTranspose2d, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax's ``ConvTranspose((2, 2), (1, 1), "SAME")``, which reads input
    rows i - 1 and i for output i (a correlation with its unflipped kernel
    padded (1, 0)): a ``ConvTranspose2d`` with no padding over the kernel
    ``convert`` flips, its last row and column cut off."""
    return _layer(deconv, h, dtype)[..., : h.shape[-2], : h.shape[-1]]


def _trunk(width: int, trunk_stages: int, trunk_depth: int, trunk_rezero: bool,
           pp_mesh, pp_n_micro: int, dtype: torch.dtype):
    """The bottleneck trunk of the conv experts (None at 0 stages)."""
    if trunk_stages <= 0:
        return None
    from mmvae_torch.models.pipeline import PipelineTrunk

    return PipelineTrunk(trunk_stages, width, trunk_depth, rezero=trunk_rezero,
                         pp_mesh=pp_mesh, pp_n_micro=pp_n_micro, dtype=dtype)


class ConvEncoder(nn.Module):
    """Strided-conv image encoder -> ``(mu, logvar)``.

    Each stage is a 4x4 stride-2 SAME conv and a swish, halving the
    spatial dims (rounding up); then a ``fc_hidden`` dense layer and the
    head. With ``channels > 1`` the input is NHWC and stage 0 runs in
    ``ops.conv4x4s2_swish`` (K4 on the card), which gives NCHW: at float32
    it reads the batch as it is (a bf16 batch too, into f32 outputs), at
    bfloat16 the batch, the weight and the bias all in bf16 (a bf16
    output); a grayscale stage 0 stays a ``Conv2d``, its input cast to the
    compute dtype.

    ``space_to_depth = r > 1`` folds r x r patches into the channels
    (:func:`_space_to_depth`) and makes stage 0 a 2x2 stride-1 ``Conv2d``
    over ``r*r*channels`` (Flax pads it (0, 1)); K4 does not run then.
    ``trunk_stages > 0`` puts a :class:`~mmvae_torch.models.pipeline.PipelineTrunk`
    of width ``fc_hidden`` (``trunk``) between the dense layer and the
    head, as ``mmvae_tpu/models/experts.py:232-239`` does.
    """

    def __init__(
        self,
        n_latents: int,
        image_hw: tuple[int, int],
        features: Sequence[int] = (32, 64),
        fc_hidden: int = 512,
        space_to_depth: int = 1,
        channels: int = 1,
        trunk_stages: int = 0,
        trunk_depth: int = 1,
        trunk_rezero: bool = True,
        pp_mesh=None,
        pp_n_micro: int = 4,
        dtype: torch.dtype = torch.float32,
        tp_mesh=None,
    ):
        super().__init__()
        r = space_to_depth
        if r > 1 and any(d % r for d in image_hw):
            raise ValueError(f"space_to_depth={r} does not divide the image {tuple(image_hw)}")
        self.n_latents = n_latents
        self.dtype = dtype
        self.channels = channels
        self.space_to_depth = r
        widths = (channels * r * r, *features)
        self.convs = nn.ModuleList(
            nn.Conv2d(a, b, 4, stride=2) for a, b in zip(widths[:-1], widths[1:])
        )
        if r > 1:
            self.convs[0] = nn.Conv2d(widths[0], widths[1], 2)
            out_h, out_w = (_conv_out(d // r, len(features) - 1) for d in image_hw)
        else:
            out_h, out_w = (_conv_out(d, len(features)) for d in image_hw)
        self.layers = _hidden_layers(out_h * out_w * features[-1], (fc_hidden,))
        self.trunk = _trunk(fc_hidden, trunk_stages, trunk_depth, trunk_rezero, pp_mesh,
                            pp_n_micro, dtype)
        self.head = nn.Linear(fc_hidden, 2 * n_latents)
        self.tp = plan_expert(self, tp_mesh)

    def forward(self, x: torch.Tensor):
        _tp_start(self)
        dtype = self.dtype
        convs = list(self.convs)
        if self.space_to_depth > 1:
            stage0 = convs.pop(0)
            h = x[..., None] if self.channels == 1 else x
            h = _space_to_depth(h.to(dtype), self.space_to_depth)
            h = swish(_conv2x2(stage0, h.permute(0, 3, 1, 2), dtype))  # NCHW
        elif self.channels == 1:
            h = x[:, None].to(dtype)  # NCHW
        else:
            stage0 = convs.pop(0)
            w, b = stage0.weight, stage0.bias
            if dtype != torch.float32:
                x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
            col = getattr(stage0, "tp_kind", None) == "col"
            if col:  # K4 on the rank's 32 / tp channels
                x = copy_in(x, self.tp)
            h = ops.conv4x4s2_swish(x, w, b)  # NCHW
            if col:
                self.tp.sharded = True
        for conv in convs:
            h = swish(_layer(conv, F.pad(h, same_pad(h.shape[-2:])), dtype))
        h = _whole(self, h, 1).permute(0, 2, 3, 1).flatten(1)  # Flax flattens NHWC
        h = _run(self.layers, h, dtype)
        if self.trunk is not None:
            h = self.trunk(_whole(self, h, -1))
        out = _whole(self, _layer(self.head, h, dtype), -1)
        return _split_head(out.float(), self.n_latents)


class DeconvDecoder(nn.Module):
    """Transposed-conv image decoder: latent -> per-pixel logits.

    Mirror of :class:`ConvEncoder`: ``layers.0`` (Flax ``Dense_0``, to
    ``fc_hidden``), the optional ``trunk`` (``PipelineTrunk_0``) and
    ``head`` (``Dense_1``, to the bottleneck grid of ``ceil(out_hw /
    2**stages)`` by ``features[0]``), each dense layer with a swish; then
    the upsampling stages and a last layer to the logits. The grid
    overshoots a non-power-of-two target (50x50 from 4x4 -> 64x64) and the
    TOP-LEFT ``out_hw`` is kept, as in the JAX decoder. Logits are ``(B,
    H, W)`` for one channel, else NHWC ``(B, H, W, channels)``.

    ``upsample_mode="deconv"``: 4x4 stride-2 transposed convs
    (``deconvs``), swish between them, and a last one to ``channels``;
    Flax's ``ConvTranspose`` does not flip its kernel, so ``convert`` flips
    it into ``deconvs.{i}.weight``. ``"shuffle"``: each stage a 2x2
    stride-1 conv to 4x the features (``convs``, Flax's ``Conv_{i}``),
    :func:`_depth_to_space` by 2 and a swish, and the last a 2x2 conv to
    ``4 * channels`` and a depth-to-space. ``space_to_depth = r > 1``: the
    last layer is a 2x2 stride-1 transposed conv to ``r*r*channels``
    (the last of ``deconvs``) and a depth-to-space by r, under either mode
    (``mmvae_tpu/models/experts.py:340-376``).
    """

    def __init__(
        self,
        n_latents: int,
        out_hw: tuple[int, int],
        features: Sequence[int] = (64, 32),
        fc_hidden: int = 512,
        upsample_mode: str = "deconv",
        channels: int = 1,
        space_to_depth: int = 1,
        trunk_stages: int = 0,
        trunk_depth: int = 1,
        trunk_rezero: bool = True,
        pp_mesh=None,
        pp_n_micro: int = 4,
        dtype: torch.dtype = torch.float32,
        tp_mesh=None,
    ):
        super().__init__()
        if upsample_mode not in ("deconv", "shuffle"):
            raise ValueError(f"unknown upsample_mode {upsample_mode!r}; have 'deconv', 'shuffle'")
        self.out_hw = tuple(out_hw)
        self.dtype = dtype
        self.channels = channels
        self.features = tuple(features)
        self.upsample_mode = upsample_mode
        self.space_to_depth = r = space_to_depth
        n_stages = len(self.features)
        self.base_hw = tuple(-(-d // 2**n_stages) for d in self.out_hw)
        self.layers = _hidden_layers(n_latents, (fc_hidden,))
        self.trunk = _trunk(fc_hidden, trunk_stages, trunk_depth, trunk_rezero, pp_mesh,
                            pp_n_micro, dtype)
        self.head = nn.Linear(fc_hidden, math.prod(self.base_hw) * self.features[0])
        pairs = list(zip(self.features[:-1], self.features[1:]))
        last_in = self.features[-1]
        self.convs = nn.ModuleList()
        self.deconvs = nn.ModuleList()
        if upsample_mode == "shuffle":
            self.convs.extend(nn.Conv2d(a, 4 * b, 2) for a, b in pairs)
        else:
            self.deconvs.extend(nn.ConvTranspose2d(a, b, 4, stride=2, padding=1)
                                for a, b in pairs)
        if r > 1:
            self.deconvs.append(nn.ConvTranspose2d(last_in, channels * r * r, 2))
        elif upsample_mode == "shuffle":
            self.convs.append(nn.Conv2d(last_in, 4 * channels, 2))
        else:
            self.deconvs.append(nn.ConvTranspose2d(last_in, channels, 4, stride=2, padding=1))
        self.tp = plan_expert(self, tp_mesh)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        _tp_start(self)
        dtype = self.dtype
        h = _run(self.layers, z.to(dtype), dtype)
        if self.trunk is not None:
            h = self.trunk(_whole(self, h, -1))
        h = _whole(self, swish(_layer(self.head, h, dtype)), -1)
        h = h.reshape(z.shape[0], *self.base_hw, self.features[0]).permute(0, 3, 1, 2)
        up = self.convs if self.upsample_mode == "shuffle" else self.deconvs
        for layer in up[: len(self.features) - 1]:
            if self.upsample_mode == "shuffle":
                h = swish(_shuffle_up(_whole(self, _conv2x2(layer, h, dtype), 1), 2))
            else:
                h = swish(_layer(layer, h, dtype))
        if self.space_to_depth > 1:
            h = _deconv2x2(self.deconvs[-1], h, dtype)
            h = _shuffle_up(_whole(self, h, 1), self.space_to_depth)
        elif self.upsample_mode == "shuffle":
            h = _shuffle_up(_whole(self, _conv2x2(self.convs[-1], h, dtype), 1), 2)
        else:
            h = _whole(self, _layer(self.deconvs[-1], h, dtype), 1)
        h = h[:, :, : self.out_hw[0], : self.out_hw[1]].float()
        return h[:, 0] if self.channels == 1 else h.permute(0, 2, 3, 1)


def _bank_group(bank: nn.Module, tp_mesh) -> TPGroup | None:
    """The model group a bank's attributes are cut over: where ``tp_mesh``
    has one of more than one rank and the attributes divide over it
    (``parallel.tp.is_bank``; CelebA's 18 split 9 and 9 at tp = 2 and stay
    whole at tp = 4)."""
    if tp_mesh is None or tp_mesh.model_size <= 1 or not is_bank(bank, tp_mesh.model_size):
        return None
    return TPGroup(tp_mesh)


class AttributeEncoderBank(nn.Module):
    """All binary-attribute experts as one stacked bank: attribute ``a``'s
    value selects a row of ``embed[a]``, then a swish hidden layer and a
    head, each one ``einsum`` over the stack.

    ``(B, A)`` attributes in {0, 1} -> ``(mu, logvar)``, each ``(B, A, L)``.
    Parameters as in Flax: ``embed`` ``(A, 2, E)``, ``w1`` ``(A, E, H)``,
    ``b1`` ``(A, H)``, ``w2`` ``(A, H, 2L)``, ``b2`` ``(A, 2L)``.
    """

    def __init__(
        self, n_latents: int, n_attrs: int = 18, embed_dim: int = 32, hidden: int = 64,
        dtype: torch.dtype = torch.float32, tp_mesh=None,
    ):
        super().__init__()
        self.n_latents = n_latents
        self.dtype = dtype
        self.embed = nn.Parameter(torch.empty(n_attrs, 2, embed_dim))
        self.w1 = nn.Parameter(torch.empty(n_attrs, embed_dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(n_attrs, hidden))
        self.w2 = nn.Parameter(torch.empty(n_attrs, hidden, 2 * n_latents))
        self.b2 = nn.Parameter(torch.zeros(n_attrs, 2 * n_latents))
        self.tp = _bank_group(self, tp_mesh)

    def forward(self, attrs: torch.Tensor):
        dt = self.dtype
        if self.tp is not None:  # this rank's attributes
            k = self.embed.shape[0]
            attrs = attrs[:, self.tp.rank * k:(self.tp.rank + 1) * k]
        a = attrs.to(torch.float32)[..., None]  # (B, A, 1)
        h = (self.embed[None, :, 0] * (1.0 - a) + self.embed[None, :, 1] * a).to(dt)
        h = swish(torch.einsum("bae,aeh->bah", h, self.w1.to(dt)) + self.b1.to(dt))
        out = (torch.einsum("bah,aho->bao", h, self.w2.to(dt)) + self.b2.to(dt)).float()
        if self.tp is not None:
            out = gather_out(out, self.tp, 1)
        return out[..., : self.n_latents], out[..., self.n_latents :]


class AttributeDecoderBank(nn.Module):
    """Latent -> ``(B, A)`` per-attribute Bernoulli logits, one stacked
    bank: ``w1`` ``(A, L, H)``, ``b1`` ``(A, H)``, ``w2`` ``(A, H)``,
    ``b2`` ``(A,)``."""

    def __init__(self, n_latents: int, n_attrs: int = 18, hidden: int = 64,
                 dtype: torch.dtype = torch.float32, tp_mesh=None):
        super().__init__()
        self.dtype = dtype
        self.w1 = nn.Parameter(torch.empty(n_attrs, n_latents, hidden))
        self.b1 = nn.Parameter(torch.zeros(n_attrs, hidden))
        self.w2 = nn.Parameter(torch.empty(n_attrs, hidden))
        self.b2 = nn.Parameter(torch.zeros(n_attrs))
        self.tp = _bank_group(self, tp_mesh)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.tp is not None:
            z = copy_in(z, self.tp)
        h = swish(torch.einsum("bl,alh->bah", z.to(dt), self.w1.to(dt)) + self.b1.to(dt))
        out = (torch.einsum("bah,ah->ba", h, self.w2.to(dt)) + self.b2.to(dt)).float()
        return out if self.tp is None else gather_out(out, self.tp, 1)
