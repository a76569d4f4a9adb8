"""Training (counterpart of `vampnet_tpu/train/`): the coarse/c2f training
step and its Noam schedule. The loop, datasets, tracker and checkpoints are
not ported yet."""
from .scheduler import noam_schedule  # noqa: F401
from .step import (  # noqa: F401
    Optimizer,
    TrainState,
    loss_and_grads,
    loss_and_metrics,
    make_optimizer,
    make_train_step,
)
