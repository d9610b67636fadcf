"""Training substrate: loss, AdamW, train-step factory."""

from .loss import cross_entropy_loss
from .optim import AdamWConfig, adamw_init, adamw_update, opt_specs
from .step import AUX_WEIGHT, TrainState, loss_and_grads, make_train_step

__all__ = ["cross_entropy_loss", "AdamWConfig", "adamw_init",
           "adamw_update", "opt_specs", "AUX_WEIGHT", "TrainState", "loss_and_grads",
           "make_train_step"]
