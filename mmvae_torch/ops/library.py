"""The kernels a traced program reaches, as ``torch.library`` custom ops.

``torch.export`` cannot trace a ``ctypes`` launch, so the two kernels that
``generate`` runs are registered as operators of the ``mmvae`` namespace,
each with three registrations:

  * ``mmvae::conv4x4s2_swish(x, weight, bias)`` -- K4
    (``kernels.conv4x4s2_swish_kernel``) for CUDA tensors, its plain version
    (``kernels.conv4x4s2_swish_torch``) for CPU tensors, and a fake that
    gives ``(B, F, ceil(H/2), ceil(W/2))`` in the type ``x`` and the weight
    promote to;
  * ``mmvae::poe_kl(mu_e, lv_e, masks, presence)`` -- the fused PoE + KL
    (``kernels.poe_kl_kernel``, its inputs made f32 and contiguous) for
    CUDA tensors, ``kernels.poe_kl_torch`` for CPU tensors, and a fake that
    gives ``(T, B, L)`` twice and ``(T, B)`` in f32.

The fakes work at a symbolic batch. The CUDA registration always launches
the kernel (and adds to ``kernels.LAUNCHES``): a failed build or launch
raises and is never handed to the plain version. The backend rule
(``ops.set_backend``) is the wrappers' in ``mmvae_torch.ops``, which emit
these ops under ``"auto"`` and ``"kernel"`` and the plain functions under
``"torch"``. Importing this module registers the ops.
"""

from __future__ import annotations

import torch

from mmvae_torch.ops import kernels

__all__ = ["LIBRARY"]

LIBRARY = torch.library.Library("mmvae", "DEF")
LIBRARY.define("conv4x4s2_swish(Tensor x, Tensor weight, Tensor bias) -> Tensor")
LIBRARY.define(
    "poe_kl(Tensor mu_e, Tensor lv_e, Tensor masks, Tensor? presence) -> (Tensor, Tensor, Tensor)"
)


def _f32(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.to(torch.float32).contiguous()


def _conv_cuda(x, weight, bias):
    return kernels.conv4x4s2_swish_kernel(x.contiguous(), weight.contiguous(), bias.contiguous())


def _conv_cpu(x, weight, bias):
    # Contiguous NCHW, as the kernel gives it (cuDNN's output of the NHWC
    # view is channels-last).
    return kernels.conv4x4s2_swish_torch(x, weight, bias).contiguous()


def _conv_fake(x, weight, bias):
    b, h, w, _ = x.shape
    return x.new_empty((b, weight.shape[0], -(-h // 2), -(-w // 2)),
                       dtype=torch.promote_types(x.dtype, weight.dtype))


def _poe_kl_cuda(mu_e, lv_e, masks, presence):
    return kernels.poe_kl_kernel(*(_f32(t) for t in (mu_e, lv_e, masks, presence)))


def _poe_kl_cpu(mu_e, lv_e, masks, presence):
    mu_f, lv_f, kl = kernels.poe_kl_torch(mu_e, lv_e, masks, presence)
    return mu_f.to(torch.float32), lv_f.to(torch.float32), kl.to(torch.float32)


def _poe_kl_fake(mu_e, lv_e, masks, presence):
    b, _, l = mu_e.shape
    t = masks.shape[0]
    mu_f = mu_e.new_empty((t, b, l), dtype=torch.float32)
    return mu_f, torch.empty_like(mu_f), mu_e.new_empty((t, b), dtype=torch.float32)


LIBRARY.impl("conv4x4s2_swish", _conv_cuda, "CUDA")
LIBRARY.impl("conv4x4s2_swish", _conv_cpu, "CPU")
LIBRARY.impl("poe_kl", _poe_kl_cuda, "CUDA")
LIBRARY.impl("poe_kl", _poe_kl_cpu, "CPU")
torch.library.register_fake("mmvae::conv4x4s2_swish", _conv_fake, lib=LIBRARY)
torch.library.register_fake("mmvae::poe_kl", _poe_kl_fake, lib=LIBRARY)
