"""Training: the train state, Adam with its schedule, the train step (also
fused with on-device data synthesis) and the training loop (``train.loop``,
imported on its own: it pulls in the data pipeline and checkpoints)."""

from spatiotemporal_variable_separation_tpu_torch.train.state import TrainState, create_train_state
from spatiotemporal_variable_separation_tpu_torch.train.step import (
    datagen_batch,
    make_fused_datagen_step,
    make_optimizer,
    make_train_step,
    multistep_lr,
    step_seed,
)

__all__ = ["TrainState", "create_train_state", "datagen_batch", "make_fused_datagen_step",
           "make_optimizer", "make_train_step", "multistep_lr", "step_seed"]
