"""Importance-weighted marginal log-likelihood (port of ``mmvae_tpu/core/iwae.py``).

The MVAE paper's test log p(x), estimated by importance sampling from the
joint PoE posterior:

    log p(x) >= log (1/k) sum_i  p(x | z_i) p(z_i) / q(z_i | x),
    z_i ~ q(z | x)

(IWAE, Burda et al. 2016). As in the JAX package, the k samples fold into
the batch axis B-MAJOR (row ``b * k + t``) for one decoder pass; the
targets stay untiled and ``model.nll_all`` reads them through the b-major
row map (on the card, K2's and K3's), and the teacher-forced sequence
decoders get their tokens tiled b-major (``_tile_terms``). The posterior
is ``ops.poe_kl`` under one all-ones mask, its KL unused, so the card runs
the fused kernel.
"""

from __future__ import annotations

import math

import torch

from mmvae_torch import ops
from mmvae_torch.core.likelihoods import gaussian_nll

__all__ = ["iwae_bound"]


def _diag_normal_logpdf(z, mu, logvar):
    """log N(z; mu, diag exp(logvar)), summed over the latent dim."""
    return -gaussian_nll(mu, z, logvar, event_ndims=1)


def iwae_bound(
    model,
    batch: dict[str, torch.Tensor],
    k: int = 64,
    *,
    generator: torch.Generator | None = None,
    eps: torch.Tensor | None = None,
    mesh=None,
) -> torch.Tensor:
    """Per-example IWAE estimate of log p(x) of the joint batch, ``(B,)``.

    ``batch`` maps every modality to its targets (all observed: the
    marginal is the joint likelihood); a ``presence`` key is ignored.
    ``eps`` ``(B, k, L)`` is the standard-normal noise; without it the
    noise is drawn from ``generator`` (on the model's device). The raw
    modality NLLs are summed (no lambdas: those weigh the training loss,
    not the likelihood). ``k=1`` is the single-sample ELBO estimator.
    With a ``mesh`` (``parallel.make_mesh``) ``batch`` is this rank's rows
    of the global batch, and the drawn noise is the global batch's, of
    which the rank keeps its rows.
    """
    data = {name: v for name, v in batch.items() if name != "presence"}
    mu_e, lv_e = model.encode(data)  # (B, M, L)
    ones = mu_e.new_ones((1, mu_e.shape[1]))
    mu_f, lv_f, _ = ops.poe_kl(mu_e, lv_e, ones)
    mu, logvar = mu_f[0], lv_f[0]  # the joint posterior, (B, L)
    b = mu.shape[0]
    if eps is None:
        # With a mesh, the global batch's noise and this rank's rows of it.
        ranks = 1 if mesh is None else mesh.n_shards
        eps = torch.randn((b * ranks, k, mu.shape[1]), generator=generator, device=mu.device,
                          dtype=mu.dtype)
        if ranks > 1:
            eps = mesh.rows(eps)
    z = mu[:, None] + torch.exp(0.5 * logvar)[:, None] * eps  # (B, k, L)
    log_q = _diag_normal_logpdf(z, mu[:, None], logvar[:, None])  # (B, k)
    log_prior = _diag_normal_logpdf(
        z, torch.zeros_like(mu)[:, None], torch.zeros_like(logvar)[:, None]
    )
    z_flat = z.reshape(b * k, -1)
    seq_names = [s.name for s in model.specs() if s.kind == "seq"]
    decode_batch = None
    if seq_names:
        decode_batch = {
            n: ops.kernels.tile_rows(data[n], b * k, ops.kernels.FOLD_B) for n in seq_names
        }
    recons = model.decode(z_flat, decode_batch)
    nll = model.nll_all(recons, data)  # (M, B * k), b-major
    log_px_given_z = -nll.reshape(model.n_modalities, b, k).sum(0)  # (B, k)
    log_w = log_px_given_z + log_prior - log_q
    return torch.logsumexp(log_w, dim=1) - math.log(k)
