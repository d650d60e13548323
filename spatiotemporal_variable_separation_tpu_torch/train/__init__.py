"""Training: the train state, Adam with its schedule, and the train step."""

from spatiotemporal_variable_separation_tpu_torch.train.state import TrainState, create_train_state
from spatiotemporal_variable_separation_tpu_torch.train.step import (
    make_optimizer,
    make_train_step,
    multistep_lr,
)

__all__ = ["TrainState", "create_train_state", "make_optimizer", "make_train_step",
           "multistep_lr"]
