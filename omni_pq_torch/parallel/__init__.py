"""Data parallelism of the port: torch.distributed in place of the JAX
package's device mesh (`omni_pq_tpu/parallel/`)."""
from .dist import (BACKEND_ENV, DataParallel, all_reduce_grads,
                   all_reduce_sum, batch_segments, broadcast_state, current,
                   data_parallel, gather_rows, gather_scenes,
                   init_distributed, moments, per_host_batch_size, rank,
                   using, world)

__all__ = ["BACKEND_ENV", "DataParallel", "all_reduce_grads",
           "all_reduce_sum", "batch_segments", "broadcast_state", "current",
           "data_parallel", "gather_rows", "gather_scenes",
           "init_distributed", "moments", "per_host_batch_size", "rank",
           "using", "world"]
