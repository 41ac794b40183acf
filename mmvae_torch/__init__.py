"""mmvae_torch: the multimodal VAE stack in PyTorch, with hand-written CUDA
kernels for an NVIDIA H100 (sm_90a).

A port of ``mmvae_tpu`` (JAX/Flax/Pallas on a TPU), which stays in the
repository as the reference; this package imports nothing of it. Ported so
far: the MNIST inference path -- :func:`mmvae_torch.api.eval_elbo`,
:func:`~mmvae_torch.api.generate` and :func:`~mmvae_torch.api.sample` --
whose KL and BCE row reductions run in ``ops/csrc/row_reduce.cu``.
"""
