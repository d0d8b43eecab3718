"""DP x TP on torch.distributed: process-group start-up, the (data,
model) mesh and the Megatron sharding rules (port of `parallel/`)."""

from .distributed import (initialize_distributed, is_main_process,  # noqa: F401
                          local_batch_slice, local_device)
from .mesh import AXIS_DATA, AXIS_MODEL, PartitionSpec, make_mesh  # noqa: F401
from .sharding import (align_pspecs, gather_params, param_pspecs,  # noqa: F401
                       shard_params)
