"""The data-parallel layout (port of streamflow_tpu/parallel/mesh.py):
parameters replicated on every rank, the global batch split over the
ranks along its leading axis.

JAX builds a device mesh and lets XLA insert the collectives; here one
process per GPU forms a ``torch.distributed`` group, ``replicate``
broadcasts the model from rank 0, and the step reduces its gradients
over the group (``training/step.py::shard_train_step``). The mesh's
``seq`` axis (``parallel/seq.py``: the image's H axis sharded over
devices) is not ported: it needs halo exchanges by hand in every conv,
attention and lookup of the forward (ROADMAP A10b).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from streamflow_tpu_torch.layers.common import sync_batchnorm
from streamflow_tpu_torch.parallel.multihost import (is_initialized,
                                                     process_count)

__all__ = ["make_mesh", "replicate", "shard_batch", "sync_batchnorm"]


def make_mesh(n_data: Optional[int] = None, n_seq: int = 1):
    """The group of the data axis: the default group, of ``n_data``
    processes (every process when None); None without a group (a single
    process). ``n_seq > 1`` raises (ROADMAP A10b)."""
    if n_seq != 1:
        raise NotImplementedError(
            "make_mesh: a 'seq' axis (parallel/seq.py, the image's H axis "
            "over devices) is not ported; see ROADMAP.md A10b")
    world = process_count()
    if n_data is not None and n_data != world:
        raise ValueError(f"make_mesh: n_data={n_data} but {world} "
                         f"processes")
    return dist.group.WORLD if is_initialized() else None


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from rank 0, in
    place (one broadcast per dtype and device), so that every rank starts
    from the same weights, whatever each did to them before (a restore
    that differs between ranks included). A no-op without a group."""
    if not is_initialized():
        return module
    bins: Dict[tuple, list] = {}
    for t in list(module.parameters()) + list(module.buffers()):
        bins.setdefault((t.dtype, t.device), []).append(t)
    for ts in bins.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, 0)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))
    return module


def shard_batch(batch: Dict, rank: int, world: int) -> Dict:
    """Rank ``rank``'s rows of a global batch: the ``rank``-th of
    ``world`` equal blocks along the leading axis of every entry (JAX's
    ``shard_batch`` puts them on device ``rank`` of the data axis). The
    batch must divide by ``world``."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % world:
            raise ValueError(f"shard_batch: {k} has {v.shape[0]} rows, "
                             f"not a multiple of {world}")
        b = v.shape[0] // world
        out[k] = v[rank * b:(rank + 1) * b]
    return out
