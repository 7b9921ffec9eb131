"""Host-side input pipeline (port of streamflow_tpu/data/loader.py; it
replaces the reference's torch DataLoader: workers=8, shuffle, drop_last,
core/mf_datasets.py:1453-1454): a shuffled batch loader over a
ClipDataset/MixedDataset, and ``prefetch_to_device``, which keeps the next
batches' host-to-device copies running beside the step.

Each sample gets its own explicitly seeded np.random.Generator (epoch-,
index- and host-dependent), so augmentation is reproducible whatever the
worker scheduling, and the batches are the JAX loader's bit for bit.
The loader overlaps disk and augmentation with device compute through a
thread pool (cv2/PIL release the GIL) and a bounded queue of numpy
batches.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator

import numpy as np
import torch


class DataLoader:
    """``process_index``/``process_count`` shard the (seed-consistent) global
    shuffle per host for multi-host training: every host draws the SAME
    permutation, then takes its strided slice — disjoint coverage with no
    coordination traffic. ``batch_size`` is the PER-HOST batch size."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 8, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 4,
                 process_index: int = 0, process_count: int = 1):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} not in "
                             f"[0, {process_count})")
        self.process_index = process_index
        self.process_count = process_count

    def _host_len(self):
        return len(self.ds) // self.process_count

    def __len__(self):
        n = self._host_len()
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield batches {'images','flows','valids', ...} stacked on axis 0.
        An error in a worker is raised here, in the consumer."""
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        if self.process_count > 1:
            # strided per-host slice of the shared permutation, truncated so
            # every host sees the same number of batches (no host can run
            # ahead into a collective the others never reach)
            order = order[self.process_index::self.process_count]
            order = order[: self._host_len()]
        nb = len(self)

        def load_one(flat_idx: int):
            idx = int(order[flat_idx])
            rng = np.random.default_rng(
                (self.seed, epoch, flat_idx, self.process_index, 0x5F3759DF))
            return self.ds.load(idx, rng)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a consumer that stopped early reads no more: do not block on
            # a full queue then
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.workers) as pool:
                    for b in range(nb):
                        lo = b * self.bs
                        samples = list(pool.map(load_one,
                                                range(lo, lo + self.bs)))
                        # stack every array key the dataset provides
                        # (bithings adds flows_bw/valids_bw; eval datasets
                        # add frame_ids)
                        batch = {k: np.stack([s[k] for s in samples])
                                 for k in samples[0]}
                        if not put(batch):
                            return
            except Exception as e:   # raised in the consumer
                put(e)
                return
            put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()

    def __iter__(self):
        return self.epoch(0)


def prefetch_to_device(batches: Iterable[Dict[str, np.ndarray]], device,
                       depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Host-to-device double buffering (the torch form of the JAX loader's
    ``prefetch_to_device``, :106-138): keep ``depth`` batches in flight to
    the card while the step computes on the current one. The reference
    has no analogue: its DataLoader hands CPU tensors to a blocking .cuda()
    copy every step (train_mf.py:231-234).

    On a CUDA ``device`` each array is copied into a pinned host buffer,
    then by a ``non_blocking`` copy on a side stream into a tensor on the
    card; before a batch is handed over, the consumer's stream (the current
    stream at that moment) waits on the copy's event, and each of its
    tensors is ``record_stream``ed on that stream, so that the caching
    allocator does not give its memory to the side stream again while the
    consumer may still read it.

    A pinned buffer must not be refilled while its asynchronous copy may
    still read it. The buffers form a ring of ``depth + 1`` per key, each
    with the event of its last copy: a buffer is refilled ``depth + 1``
    batches after it was filled, once the host has waited on that event
    (by then the copy is long done, so the wait costs nothing).

    On ``device="cpu"`` the arrays only become tensors (sharing the numpy
    memory): CPU-only torch cannot pin, and the CPU was asked for."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            yield {k: torch.from_numpy(v) for k, v in batch.items()}
        return

    side = torch.cuda.Stream(device)
    ring = [dict() for _ in range(depth + 1)]     # slot -> {key: pinned}
    done = [None] * (depth + 1)                   # slot -> its copy's event
    buf = collections.deque()

    def put(batch, slot):
        if done[slot] is not None:
            done[slot].synchronize()
        pinned, out = ring[slot], {}
        for k, v in batch.items():
            v = torch.from_numpy(np.ascontiguousarray(v))
            p = pinned.get(k)
            if p is None or p.shape != v.shape or p.dtype != v.dtype:
                p = pinned[k] = torch.empty(v.shape, dtype=v.dtype,
                                            pin_memory=True)
            p.copy_(v)
            with torch.cuda.stream(side):
                out[k] = torch.empty(v.shape, dtype=v.dtype, device=device)
                out[k].copy_(p, non_blocking=True)
        done[slot] = torch.cuda.Event()
        done[slot].record(side)
        return out, done[slot]

    def hand_over(item):
        out, event = item
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(event)
        for t in out.values():
            t.record_stream(consumer)
        return out

    slot = 0
    for batch in batches:
        buf.append(put(batch, slot))
        slot = (slot + 1) % (depth + 1)
        if len(buf) == depth:
            yield hand_over(buf.popleft())
    while buf:
        yield hand_over(buf.popleft())
