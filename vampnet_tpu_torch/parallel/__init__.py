"""Multi-device inference (counterpart of `vampnet_tpu/parallel/`): meshes,
multi-process start-up, and the LM's partition specs. Importing it does not
start `torch.distributed`."""
from .mesh import Mesh, make_mesh, make_sp_mesh, multihost_init  # noqa: F401
from .partition import (P, lm_param_specs, opt_state_specs, tp_shard_state_dict,  # noqa: F401
                        zero1_specs)
