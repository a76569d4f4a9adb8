"""Multi-device inference and training (counterpart of
`vampnet_tpu/parallel/`): meshes, multi-process start-up, the LM's partition
specs and the shards they cut. Importing it does not start
`torch.distributed`."""
from .mesh import (Mesh, dp_group, make_mesh, make_sp_mesh, make_train_mesh,  # noqa: F401
                   multihost_init, process_count, process_index)
from .partition import (P, lm_param_specs, opt_state_specs, tp_dim, tp_gather,  # noqa: F401
                        tp_shard_state_dict, tp_slice, zero1_specs)
