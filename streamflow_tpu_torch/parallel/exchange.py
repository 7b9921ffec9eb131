"""Row exchanges of the sequence-sharded forward (``parallel/seq.py``): a
grid split along its rows into contiguous slabs, one per rank of a seq
group, and the three exchanges its layers need, each by the collective
that JAX's partitioner (GSPMD) inserts for it. A slab may hold any
number of rows, none included.

- ``halo``: a slab extended by the ``k`` rows above and below it, for a
  layer whose window reaches ``k`` rows across a slab edge (a kxk conv
  reaches k // 2); GSPMD's collective permute, here point-to-point sends
  and receives, all of one halo posted together (``batch_isend_irecv``,
  by peer). The rows come from whichever ranks hold them: a slab thinner
  than ``k`` passes its rows on to ranks beyond its neighbours. The rows
  that one rank needs of another's slab are one run, since that slab
  lies wholly above or wholly below its own (``_needs``, from the bounds
  alone, the same on every rank): at most one message each way between
  two ranks. A slab at the grid's own edge gets nothing there: the layer
  pads that edge as it does on the whole grid. An empty slab sends and
  receives nothing and takes no halo.
- ``gather``: the whole grid from every rank's slab, for a layer that
  needs it all (attention keys and values, the correlation pyramid, the
  output): one ``all_gather`` of the slabs, each padded to the largest
  slab's rows, cut back to their rows in rank order. Slabs may differ in
  size, and may be empty.
- ``sum``: an f32 tensor summed over the group by one ``all_reduce``
  (the slabs' partial sums of a statistic over the whole grid:
  InstanceNorm's mean and variance); an empty slab adds zeros. The one
  exchange whose result depends on the split: the partial sums add in
  another order than one rank's sum over the whole grid, so the
  statistic may differ in its last bits. The ranks still agree bit for
  bit: the ring reduces each chunk once and passes the result on to
  every rank.

Halos and gathers move the rows' bytes, so every dtype keeps its bit
patterns (-0.0, NaN and infinities included).

The backend of the group decides the form (``Rows._staged``): under NCCL
the collectives run on the CUDA tensors themselves. Gloo runs neither
point-to-point nor ``all_gather`` on CUDA tensors, so over gloo a CUDA
tensor's bytes to send are copied to the host once per exchange, into
pinned memory, the collective runs on CPU tensors, and what arrives is
copied to the device once (the ranks that share one card). A CPU tensor
over gloo takes no copy. Any other pairing raises.

``recording`` keeps a record of the exchanges (``Exchange``: kind, bytes
sent and received, seconds); ``traffic`` gives each rank's bytes of one
exchange from the bounds alone, beside those of the form that carried
halos and gathers before: an ``all_reduce`` of a zeroed buffer of the
rows (as int32 words) that every rank joined.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import (Callable, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch
import torch.distributed as dist

Bounds = Sequence[Tuple[int, int]]

# one tensor a rank gathered into one: all_gather_single where torch has
# it (it deprecates all_gather_into_tensor, which older ones have)
_all_gather = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor")


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """x's elements as a flat uint8 view of a contiguous copy."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def _pinned(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` in pinned host memory (one copy from the card)."""
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    return out


def _ring(n: int, nbytes: float) -> float:
    """The bytes a rank sends (and receives) in a ring all_reduce of
    ``nbytes`` over ``n`` ranks."""
    return 2 * (n - 1) * nbytes / n


def _needs(bounds: Bounds, i: int, p: int, k: int) -> Tuple[int, int]:
    """The rows (lo, hi) of rank p's slab that rank i's halo of ``k``
    reads: one run, since p's slab lies wholly above or below i's; lo ==
    hi where it reads none (p == i, or either slab empty)."""
    (a, b), (c, d) = bounds[i], bounds[p]
    if p == i or a == b or c == d:
        return 0, 0
    lo, hi = (max(a - k, c), d) if d <= a else (c, min(b + k, d))
    return (lo, hi) if hi > lo else (0, 0)


def _reach(bounds: Bounds, k: int) -> List[Tuple[int, int]]:
    """The rows that the halos of ``k`` read, as disjoint runs in order:
    the ``k`` rows above and below each non-empty slab, within the grid."""
    total = bounds[-1][1]
    spans = sorted(s for a, b in bounds if b > a
                   for s in ((max(a - k, 0), a), (b, min(b + k, total)))
                   if s[1] > s[0])
    runs: List[Tuple[int, int]] = []
    for a, b in spans:
        if runs and a <= runs[-1][1]:
            runs[-1] = (runs[-1][0], max(runs[-1][1], b))
        else:
            runs.append((a, b))
    return runs


class Traffic(NamedTuple):
    """A rank's bytes of one exchange: ``sent`` and ``received`` in this
    module's form, and ``old``, what the all_reduce of a zeroed buffer
    sent (and received) there."""
    sent: float
    received: float
    old: float


def traffic(kind: str, bounds: Bounds, index: int, row_bytes: int,
            k: int = 1) -> Traffic:
    """Rank ``index``'s bytes of one exchange of ``kind`` over the slabs
    ``bounds``, from the bounds alone. ``row_bytes``: one row of the
    tensor along the exchanged dim (a sum: the whole tensor); ``k``: the
    halo's rows, or the gather's unit. A halo sends each rank the run of
    its slab that the rank reads (``_needs``) and receives its own; a
    gather, as a ring all_gather, sends and receives n - 1 chunks of the
    largest slab's rows; a sum, as a ring all_reduce, 2(n-1)/n of the
    tensor each way. ``old``: 2(n-1)/n of the buffer that the all_reduce
    carried before, int32 words of every rows that any halo reads
    (``_reach``), or of the whole grid, on every rank alike."""
    n = len(bounds)
    if kind == "sum":
        moved = _ring(n, row_bytes)
        return Traffic(moved, moved, moved)

    def words(nbytes):
        return _ring(n, 4 * -(-nbytes // 4))
    if kind == "gather":
        chunk = (n - 1) * max(b - a for a, b in bounds) * k * row_bytes
        return Traffic(chunk, chunk, words(bounds[-1][1] * k * row_bytes))
    if kind != "halo":
        raise ValueError(f"traffic: {kind!r} is not halo, gather or sum")

    def rows(i, p):
        lo, hi = _needs(bounds, i, p, k)
        return hi - lo
    return Traffic(row_bytes * sum(rows(p, index) for p in range(n)),
                   row_bytes * sum(rows(index, p) for p in range(n)),
                   words(row_bytes * sum(b - a for a, b in _reach(bounds,
                                                                  k))))


class Exchange(NamedTuple):
    """One exchange of this rank, as ``recording`` keeps it: its kind
    ("halo", "gather" or "sum"), the bytes its collectives sent and
    received (counted on the tensors handed to them; a gather's and a
    sum's as their ring moves them), whether it went through the host,
    its seconds, and what ``traffic`` prices it by."""
    kind: str
    sent: float
    received: float
    staged: bool
    seconds: float
    bounds: Tuple[Tuple[int, int], ...]
    index: int
    row_bytes: int
    k: int

    def planned(self) -> Traffic:
        return traffic(self.kind, self.bounds, self.index, self.row_bytes,
                       self.k)


_record: Optional[List[Exchange]] = None
_sync: Optional[Callable[[], None]] = None


@contextlib.contextmanager
def recording(sync: Optional[Callable[[], None]] = None
              ) -> Iterator[List[Exchange]]:
    """A list that gets one ``Exchange`` for every exchange made in the
    block, in order (no record outside one). ``sync``
    (``torch.cuda.synchronize``) runs before and after each exchange, so
    that its seconds are its own on the card."""
    global _record, _sync
    saved = _record, _sync
    _record, _sync = [], sync
    try:
        yield _record
    finally:
        _record, _sync = saved


def join(group) -> None:
    """A seq group's first collective (``make_mesh`` calls it on every
    rank of the group as it creates it): under NCCL a one-element
    all_reduce on this rank's card. NCCL sets up a group's communicator
    at its first collective, and a batch of point-to-point ops may come
    first only where every rank of the group takes part in it (torch's
    ``batch_isend_irecv``); the forward's first exchange may be a halo
    that an empty slab sits out. Gloo needs nothing."""
    if dist.get_backend(group) == "nccl":
        dist.all_reduce(torch.zeros(1, device=torch.device(
            "cuda", torch.cuda.current_device())), group=group)


class Rows:
    """This rank's slab of a grid split along its rows over a seq group.

    ``bounds`` holds every rank's (start, stop) rows, in rank order, with
    no gap and no overlap; ``index`` is this rank's place in the group
    (``group``, None for a group of one, where nothing is exchanged)."""

    def __init__(self, bounds: Sequence[Tuple[int, int]], index: int,
                 group=None):
        bounds = [(int(a), int(b)) for a, b in bounds]
        if any(b0[1] != b1[0] for b0, b1 in zip(bounds, bounds[1:])) or any(
                a > b for a, b in bounds) or bounds[0][0] != 0:
            raise ValueError(f"Rows: {bounds} are not contiguous slabs "
                             f"from row 0")
        if len(bounds) > 1 and group is None:
            raise ValueError("Rows: slabs over several ranks need a group")
        self.bounds, self.index, self.group = bounds, index, group
        self.start, self.stop = bounds[index]
        self.total = bounds[-1][1]

    @property
    def size(self) -> int:
        return self.stop - self.start

    @property
    def alone(self) -> bool:
        """One slab, the whole grid: nothing to exchange."""
        return len(self.bounds) == 1

    def coarse(self, div: int) -> "Rows":
        """The same split of the grid subsampled by ``div`` (a stride-div
        conv without padding): rank r's rows start // div to stop // div.
        Exact where every start is a multiple of div."""
        return Rows([(a // div, b // div) for a, b in self.bounds],
                    self.index, self.group)

    def fine(self, mul: int) -> "Rows":
        """The same split of a grid of ``mul`` times the rows (an
        encoder's input, whose stride-``mul`` output these rows are)."""
        return Rows([(a * mul, b * mul) for a, b in self.bounds],
                    self.index, self.group)

    def _staged(self, x: torch.Tensor) -> bool:
        """Whether an exchange of ``x`` goes through the host: a CUDA
        tensor over gloo. A CPU tensor over gloo and a CUDA tensor under
        NCCL take the collectives as they are; any other pairing raises."""
        backend = dist.get_backend(self.group)
        if backend == "gloo":
            return x.is_cuda
        if backend == "nccl" and x.is_cuda:
            return False
        raise ValueError(f"Rows: no exchange of {x.device.type} tensors "
                         f"over {backend}")

    def _start(self) -> float:
        if _record is not None and _sync is not None:
            _sync()
        return time.perf_counter()

    def _note(self, t0: float, kind: str, staged: bool, sent: float,
              received: float, row_bytes: int, k: int) -> None:
        """The exchange begun at ``t0`` into the record, if one is on."""
        if _record is None:
            return
        if _sync is not None:
            _sync()
        _record.append(Exchange(kind, sent, received, staged,
                                time.perf_counter() - t0,
                                tuple(self.bounds), self.index, row_bytes,
                                k))

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in f32 summed over the group, the same on every rank;
        every rank joins with a tensor of x's shape (an empty slab's
        zeros). A group of one returns x in f32."""
        out = x.float().contiguous()
        if self.alone:
            return out
        t0 = self._start()
        staged = self._staged(out)
        buf = _pinned(out) if staged else out.clone()
        dist.all_reduce(buf, group=self.group)
        if staged:
            buf = buf.to(out.device)
        nbytes = buf.numel() * buf.element_size()
        moved = _ring(len(self.bounds), nbytes)
        self._note(t0, "sum", staged, moved, moved, nbytes, 1)
        return buf

    def gather(self, x: torch.Tensor, dim: int = 1,
               unit: int = 1) -> torch.Tensor:
        """The whole grid, contiguous, from this rank's slab ``x`` along
        ``dim``: (stop - start) * ``unit`` entries there (``unit`` > 1 for
        an axis of rows x columns flattened, or of rows upsampled), none
        for an empty slab."""
        dim = dim % x.dim()
        if x.shape[dim] != self.size * unit:
            raise ValueError(f"Rows.gather: {x.shape[dim]} entries along "
                             f"dim {dim}, slab {self.start}:{self.stop} x "
                             f"{unit}")
        if self.alone or not self.total:
            return x
        t0 = self._start()
        xm = x.movedim(dim, 0)            # rows first: a run is contiguous
        rest = xm.shape[1:]
        row = math.prod(rest) * x.element_size()      # bytes an entry
        n = len(self.bounds)
        most = unit * max(b - a for a, b in self.bounds)
        staged = self._staged(x)
        # every slab padded to the largest one's entries (the padding is
        # never read), then all of them on every rank
        chunk = torch.empty((most, *rest), dtype=x.dtype, pin_memory=True
                            ) if staged else xm.new_empty((most, *rest))
        chunk[:xm.shape[0]].copy_(xm)
        chunk = _bytes(chunk)
        every = torch.empty(n * chunk.numel(), dtype=torch.uint8,
                            pin_memory=staged, device=chunk.device)
        _all_gather(every, chunk, group=self.group)
        every = every.view(n, chunk.numel())
        runs = [every[r, :(b - a) * unit * row]
                for r, (a, b) in enumerate(self.bounds)]
        if staged:        # cut on the host, one copy to the card
            whole = torch.empty(self.total * unit * row, dtype=torch.uint8,
                                pin_memory=True)
            whole = torch.cat(runs, out=whole).to(x.device)
        else:
            whole = torch.cat(runs)
        self._note(t0, "gather", staged, (n - 1) * chunk.numel(),
                   every.numel() - chunk.numel(), row, unit)
        whole = whole.view(x.dtype).reshape(self.total * unit, *rest)
        return whole.movedim(0, dim).contiguous()

    def reach(self, k: int) -> List[Tuple[int, int]]:
        """The rows that the halos of ``k`` read, as disjoint runs in
        order: the ``k`` rows above and below each non-empty slab, within
        the grid (what the all_reduce form's buffer held, which
        ``traffic`` prices)."""
        return _reach(self.bounds, k)

    def halo(self, x: torch.Tensor, k: int,
             dim: int = 1) -> Tuple[torch.Tensor, int]:
        """``x`` extended along ``dim`` by the ``k`` rows of the grid
        before it and after it, from whichever ranks hold them, cut short
        at the grid's edges; returns (extended, rows added before). Each
        rank sends every other the run of its slab that the other reads
        and receives the runs it reads, in one batch posted by peer; an
        empty slab exchanges nothing and gets (x, 0)."""
        dim = dim % x.dim()
        if k == 0 or self.alone:
            return x, 0
        t0 = self._start()
        xm = x.movedim(dim, 0)            # rows first: a run is contiguous
        rest = xm.shape[1:]
        row = math.prod(rest) * x.element_size()          # bytes a row
        runs = [(p, _needs(self.bounds, p, self.index, k),
                 _needs(self.bounds, self.index, p, k))
                for p in range(len(self.bounds))]      # (peer, out, in)
        staged = self._staged(x)
        outgoing = [xm[lo - self.start:hi - self.start]
                    for _, (lo, hi), _ in runs if hi > lo]
        send = _bytes(torch.cat(outgoing)) if outgoing else None
        if staged and send is not None:
            send = _pinned(send)
        got = sum(hi - lo for _, _, (lo, hi) in runs) * row
        recv = torch.empty(got, dtype=torch.uint8, pin_memory=staged,
                           device="cpu" if staged else x.device)
        ops, out_at, in_at = [], 0, 0
        for p, (lo, hi), (lo2, hi2) in runs:
            peer = dist.get_global_rank(self.group, p)
            if hi > lo:
                ops.append(dist.P2POp(dist.isend, send[
                    out_at:out_at + (hi - lo) * row], peer, self.group))
                out_at += (hi - lo) * row
            if hi2 > lo2:
                ops.append(dist.P2POp(dist.irecv, recv[
                    in_at:in_at + (hi2 - lo2) * row], peer, self.group))
                in_at += (hi2 - lo2) * row
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if staged and got:
            recv = recv.to(x.device)
        self._note(t0, "halo", staged, out_at, in_at, row, k)
        if not self.size:
            return x, 0
        # the runs arrive by peer: the ranks above, then those below, each
        # in the grid's order
        top = min(k, self.start)
        rows = recv.view(x.dtype).reshape(-1, *rest)
        ext = ([rows[:top].movedim(0, dim)] if top else []) + [x] + (
            [rows[top:].movedim(0, dim)] if rows.shape[0] > top else [])
        return torch.cat(ext, dim=dim), top

    def local(self, fn: Callable, x: torch.Tensor, k: int,
              dim: int = 1) -> torch.Tensor:
        """``fn`` (a layer that reaches ``k`` rows across a slab edge,
        along ``dim`` of its input and output) on this rank's slab: run on
        the slab extended by its halo, cropped back to the slab's rows.
        An empty slab joins the exchange and hands ``fn`` its no rows (the
        layers launch nothing there)."""
        ext, top = self.halo(x, k, dim)
        return fn(ext).narrow(dim, top, x.shape[dim])


def even_split(n: int, parts: int) -> List[Tuple[int, int]]:
    """``n`` items in ``parts`` contiguous runs as even as possible, the
    longer ones first (55 in 2: 28, 27)."""
    q, r = divmod(n, parts)
    out, a = [], 0
    for i in range(parts):
        b = a + q + (i < r)
        out.append((a, b))
        a = b
    return out
