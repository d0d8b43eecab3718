"""DP x TP on torch.distributed: process-group start-up, the (data,
model) mesh and the Megatron sharding rules (port of `parallel/`)."""

from .distributed import (initialize_distributed, is_main_process,  # noqa: F401
                          local_batch_slice, local_device)
from .mesh import (AXIS_DATA, AXIS_MODEL, PartitionSpec,  # noqa: F401
                   data_sharding, make_mesh, replicated)
from .sharding import (KV_PSPEC, KV_SCALE_PSPEC, align_pspecs,  # noqa: F401
                       gather_params, param_pspecs, shard_params)
