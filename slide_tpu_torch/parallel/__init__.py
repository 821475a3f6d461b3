"""Several processes and several devices (counterpart:
`slide_tpu/parallel/`): joining a `torch.distributed` group, gathers across
ranks, and the data-parallel training step's draws and all-reduce."""

from slide_tpu_torch.parallel.sharded import (all_reduce_mean, batch_randint,
                                                    batch_randn, broadcast_from_rank0,
                                                    current_shard, data_parallel)
from slide_tpu_torch.parallel.multihost import (global_batch_from_local,
                                                maybe_initialize_distributed,
                                                process_allgather, process_group_active,
                                                world_info)

__all__ = ["maybe_initialize_distributed", "world_info", "global_batch_from_local",
           "process_allgather", "process_group_active", "data_parallel", "current_shard",
           "batch_randn", "batch_randint", "all_reduce_mean", "broadcast_from_rank0"]
