"""Training: the train state, the steps (LM, classification, segmentation;
one process or data-parallel over a process group), the trainer."""

from deeplearning_mpi_tpu_torch.train.state import TrainState, create_train_state  # noqa: F401
from deeplearning_mpi_tpu_torch.train.trainer import (  # noqa: F401
    Trainer,
    build_lr_schedule,
    build_optimizer,
    make_eval_step,
    make_train_step,
)
