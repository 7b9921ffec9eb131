"""The data-parallel layout (port of streamflow_tpu/parallel/mesh.py):
parameters replicated on every rank, the global batch split over the
ranks along its leading axis; and the (data, seq) grid of ranks of the
sequence-sharded forward (``parallel/seq.py``).

JAX builds a device mesh and lets XLA insert the collectives; here one
process per GPU forms a ``torch.distributed`` group, ``replicate``
broadcasts the model from rank 0, and the step reduces its gradients
over the group (``training/step.py::shard_train_step``). With a ``seq``
axis the ranks form an n_data x n_seq grid, rank = d * n_seq + s (JAX's
``devices.reshape(n_data, n_seq)``), and the forward exchanges rows
within each seq group by hand (``parallel/exchange.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist

from streamflow_tpu_torch.layers.common import sync_batchnorm
from streamflow_tpu_torch.parallel.exchange import join
from streamflow_tpu_torch.parallel.multihost import (is_initialized,
                                                     process_count,
                                                     process_index)

__all__ = ["make_mesh", "replicate", "shard_batch", "sync_batchnorm",
           "SeqMesh"]


@dataclass(frozen=True)
class SeqMesh:
    """An n_data x n_seq grid of ranks: this rank's place (d, s), the
    group of its data axis (the ranks of its s, over d) and of its seq
    axis (the ranks of its d, over s)."""
    n_data: int
    n_seq: int
    d: int
    s: int
    data_group: object
    seq_group: object


def make_mesh(n_data: Optional[int] = None, n_seq: int = 1):
    """``n_seq == 1``: the group of the data axis, the default group of
    ``n_data`` processes (every process when None); None without a group
    (a single process). ``n_seq > 1``: a ``SeqMesh`` over the default
    group of n_data x n_seq processes (n_data = processes / n_seq when
    None); every rank creates every group, in the same order, and joins
    its seq group (``exchange.join``). A world of another size, or no
    group, raises a ValueError."""
    world = process_count()
    if n_seq < 1 or (n_data is not None and n_data < 1):
        raise ValueError(f"make_mesh: n_data={n_data}, n_seq={n_seq}")
    if n_seq == 1:
        if n_data is not None and n_data != world:
            raise ValueError(f"make_mesh: n_data={n_data} but {world} "
                             f"processes")
        return dist.group.WORLD if is_initialized() else None
    if not is_initialized():
        raise ValueError(f"make_mesh: n_seq={n_seq} needs a process group "
                         f"of n_data x n_seq processes (parallel.initialize)"
                         f"; this process has none")
    if n_data is None:
        n_data = world // n_seq
    if n_data * n_seq != world:
        raise ValueError(f"make_mesh: n_data={n_data} x n_seq={n_seq} but "
                         f"{world} processes")
    rank = process_index()
    d, s = divmod(rank, n_seq)
    data = seq = None
    for j in range(n_seq):               # the data groups, then the seq
        g = dist.new_group([i * n_seq + j for i in range(n_data)])
        data = g if j == s else data
    for i in range(n_data):
        g = dist.new_group([i * n_seq + j for j in range(n_seq)])
        seq = g if i == d else seq
    join(seq)       # a collective before the first halo's sends (NCCL)
    return SeqMesh(n_data, n_seq, d, s, data, seq)


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from rank 0, in
    place (one broadcast of the bytes per dtype and device), so that every
    rank starts from the same weights, whatever each did to them before (a
    restore that differs between ranks included). A no-op without a
    group."""
    if not is_initialized():
        return module
    bins: Dict[tuple, list] = {}
    for t in list(module.parameters()) + list(module.buffers()):
        bins.setdefault((t.dtype, t.device), []).append(t)
    for ts in bins.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat.view(torch.uint8), 0)   # any dtype, over gloo
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
