"""The multi-term loss, the train state and step, the eval step and the IWAE step."""

from mmvae_torch.train.state import TrainState, create_train_state, global_norm
from mmvae_torch.train.step import (
    epoch_order,
    make_epoch_runner,
    make_eval_runner,
    make_eval_step,
    make_gather_epoch_runner,
    make_iwae_runner,
    make_iwae_step,
    make_train_step,
    multi_term_loss,
    presence_from_keep,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "global_norm",
    "multi_term_loss",
    "make_train_step",
    "make_epoch_runner",
    "make_gather_epoch_runner",
    "epoch_order",
    "presence_from_keep",
    "make_eval_step",
    "make_eval_runner",
    "make_iwae_step",
    "make_iwae_runner",
]
