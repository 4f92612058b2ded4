from .checkpoint import load_checkpoint, save_checkpoint
from .model import init_transformer
from .train import (OptParams, cross_entropy_loss, init_opt_state, make_optimizer,
                    make_train_step, squared_error_loss)

__all__ = [
    "OptParams",
    "init_opt_state",
    "cross_entropy_loss",
    "squared_error_loss",
    "init_transformer",
    "make_optimizer",
    "make_train_step",
    "save_checkpoint",
    "load_checkpoint",
]
