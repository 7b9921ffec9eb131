"""Multi-process execution on torch.distributed (port of
streamflow_tpu/parallel/multihost.py, :29-85): one process per GPU, each
with its own rank of one process group.

- ``initialize`` joins the group: from JAX's three arguments (the
  coordinator's ``host:port``, or a ``tcp://`` / ``file://`` URL; the
  number of processes; this one's id), or from the environment that
  ``torchrun`` sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
  MASTER_PORT). Nothing configured: a single process, no group.
- ``local_device`` is this process's card, ``is_primary`` tells the
  process that logs, checkpoints and validates (rank 0), ``barrier``
  waits for every process on the group's store (no device collective).

JAX's ``form_global_batch`` has no counterpart: JAX assembles the hosts'
rows into one global array that its step shards, while here each rank
keeps its own rows (``DataLoader(process_index=rank,
process_count=world)``) and the step reduces over the ranks
(``training/step.py::shard_train_step``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a group)."""
    return dist.get_world_size() if is_initialized() else 1


def _init_method(address: str) -> str:
    if "://" in address:
        return address
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r} is not "
                         f"host:port or a tcp:// / file:// URL")
    return f"tcp://{host}:{port}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None,
               timeout_s: int = 1800) -> Tuple[int, int]:
    """Join the process group; returns (rank, world size).

    With ``coordinator_address`` (and then ``num_processes`` and
    ``process_id``, as JAX's), or with WORLD_SIZE in the environment
    (torchrun), the group is formed; ``backend`` defaults to NCCL when
    ``device`` (default: 'cuda' if a card is visible) is a CUDA device,
    else gloo. With none of them this is a single process and a no-op
    that returns (0, 1), as JAX's. A group formed before (by the caller)
    is kept. A failure to form the requested group raises; there is no
    single-process fallback."""
    if is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = "WORLD_SIZE" in os.environ
    if coordinator_address is None and not env:
        if num_processes not in (None, 1):
            raise ValueError(f"num_processes={num_processes} needs a "
                             f"coordinator address (or torchrun)")
        return 0, 1
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = dict(backend=backend,
              timeout=datetime.timedelta(seconds=timeout_s))
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        kw.update(init_method=_init_method(coordinator_address),
                  world_size=num_processes, rank=process_id)
    else:
        kw.update(init_method="env://")
    if backend == "nccl":
        torch.cuda.set_device(local_device(device, kw.get("rank")))
    dist.init_process_group(**kw)
    return dist.get_rank(), dist.get_world_size()


def local_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """This process's device: for a CUDA device without an index,
    ``cuda:LOCAL_RANK`` (torchrun's), else the rank modulo the cards
    visible; a device with an index, and the CPU, as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    rank = process_index() if rank is None else rank
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def is_primary() -> bool:
    """True on the process that logs, checkpoints and validates (rank
    0)."""
    return process_index() == 0


def barrier(name: str, timeout_s: int = 600) -> None:
    """Block until every process has reached the barrier ``name``, on the
    group's store (no device collective, as JAX's coordination-service
    barrier); raises after ``timeout_s``. A name may be passed again: the
    store counts the arrivals under it, and the k-th time every process
    waits for the k-th round of arrivals. A no-op in a single process."""
    if not is_initialized() or dist.get_world_size() == 1:
        return
    world = dist.get_world_size()
    key = f"streamflow_barrier/{name}"
    store = dist.distributed_c10d._get_default_store()
    arrived = store.add(key, 1)
    done = f"{key}/{(arrived - 1) // world}"
    if arrived % world == 0:
        store.set(done, b"1")
    store.wait([done], datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if is_initialized():
        dist.destroy_process_group()
