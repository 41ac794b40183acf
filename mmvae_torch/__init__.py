"""mmvae_torch: the multimodal VAE stack in PyTorch, with hand-written CUDA
kernels for an NVIDIA H100 (sm_90a).

A port of ``mmvae_tpu`` (JAX/Flax/Pallas on a TPU), which stays in the
repository as the reference; this package imports nothing of it. Ported so
far: inference -- :func:`mmvae_torch.api.eval_elbo`,
:func:`~mmvae_torch.api.log_likelihood` (the IWAE estimate of log p(x)),
:func:`~mmvae_torch.api.generate` and :func:`~mmvae_torch.api.sample` --
and training (:func:`~mmvae_torch.api.train`, with gradient accumulation,
the cosine LR schedule, ``nan_rollback`` and overlapped checkpoints) of the
``mnist``, ``fashionmnist``, ``multimnist``, ``celeba`` and ``cub``
configs, and the command line ``python -m mmvae_torch.cli``, on one card
or data parallel over a process group (``mmvae_torch.parallel``). On the
card the KL and BCE row reductions and their gradients run in
``ops/csrc/row_reduce.cu``, the product of experts with its KL and its
backward in ``ops/csrc/poe_kl.cu``, the masked sequence cross-entropy and
its gradient in ``ops/csrc/seq_ce.cu``, and the RGB image encoder's first
conv stage with its gradients in ``ops/csrc/conv_s2.cu``.
"""
