"""Training (counterpart of `vampnet_tpu/train/`): the coarse/c2f training
step and its options, on one device or sharded over a ("dp", "tp") mesh
(`ShardedTrainState`, `make_sharded_train_step`), the Noam schedule, the
loop (`loop.py`: configs, meshes and jobs of several processes, datasets,
validation, samples, resume), the datasets (`datasets.py`), the tracker
(`tracker.py`) and the checkpoint manager (`checkpoints.py`)."""
from .scheduler import noam_schedule  # noqa: F401
from .step import (  # noqa: F401
    Optimizer,
    ShardedTrainState,
    TrainState,
    lora_filter,
    loss_and_grads,
    loss_and_metrics,
    make_optimizer,
    make_sharded_train_step,
    make_train_step,
)
