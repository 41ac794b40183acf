"""The multi-term loss and the eval step (training is not ported yet)."""

from mmvae_torch.train.step import make_eval_runner, make_eval_step, multi_term_loss

__all__ = ["multi_term_loss", "make_eval_step", "make_eval_runner"]
