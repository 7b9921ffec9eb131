"""Data-parallel training over GPUs (counterpart of
streamflow_tpu.parallel): one process per GPU on torch.distributed, the
model replicated, the global batch split over the ranks, the gradients,
metrics and BatchNorm statistics reduced over them. JAX's names where a
counterpart exists; ``make_seq_sharded_forward`` (parallel/seq.py) has
none yet (ROADMAP A10b)."""

from streamflow_tpu_torch.parallel import multihost
from streamflow_tpu_torch.parallel.mesh import (make_mesh, replicate,
                                                shard_batch, sync_batchnorm)
from streamflow_tpu_torch.parallel.multihost import (barrier, initialize,
                                                     is_primary,
                                                     local_device)
from streamflow_tpu_torch.training.step import shard_train_step

__all__ = ["make_mesh", "shard_batch", "replicate", "sync_batchnorm",
           "shard_train_step", "initialize", "is_primary", "barrier",
           "local_device", "multihost"]
