"""Data-parallel training and the sequence-sharded forward over GPUs
(counterpart of streamflow_tpu.parallel): one process per GPU on
torch.distributed. Training: the model replicated, the global batch split
over the ranks, the gradients, metrics and BatchNorm statistics reduced
over them. Inference: ``make_seq_sharded_forward`` splits a clip's rows
over the ranks of a seq group (parallel/seq.py). JAX's names where a
counterpart exists."""

from streamflow_tpu_torch.parallel import multihost
from streamflow_tpu_torch.parallel.mesh import (SeqMesh, make_mesh,
                                                replicate, shard_batch,
                                                sync_batchnorm)
from streamflow_tpu_torch.parallel.multihost import (barrier, initialize,
                                                     is_primary,
                                                     local_device)
from streamflow_tpu_torch.parallel.seq import make_seq_sharded_forward
from streamflow_tpu_torch.training.step import shard_train_step

__all__ = ["make_mesh", "shard_batch", "replicate", "sync_batchnorm",
           "make_seq_sharded_forward", "SeqMesh", "shard_train_step",
           "initialize", "is_primary", "barrier", "local_device",
           "multihost"]
