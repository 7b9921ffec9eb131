"""Row exchanges of the sequence-sharded forward (``parallel/seq.py``): a
grid split along its rows into contiguous slabs, one per rank of a seq
group, and the three exchanges its layers need. A slab may hold any
number of rows, none included.

- ``halo``: a slab extended by the ``k`` rows above and below it, for a
  layer whose window reaches ``k`` rows across a slab edge (a kxk conv
  reaches k // 2). The rows come from whichever ranks hold them: a slab
  thinner than ``k`` passes its rows on to ranks beyond its neighbours.
  A slab at the grid's own edge gets nothing there: the layer pads that
  edge as it does on the whole grid. An empty slab takes no halo.
- ``gather``: the whole grid from every rank's slab, for a layer that
  needs it all (attention keys and values, the correlation pyramid, the
  output). Slabs may differ in size, and may be empty.
- ``sum``: an f32 tensor summed over the group (the slabs' partial sums
  of a statistic over the whole grid: InstanceNorm's mean and variance);
  an empty slab adds zeros.

All three are carried by ``all_reduce``, the collective that gloo also
runs on CUDA tensors (with ``broadcast``), so the same code runs two
ranks that share one card over gloo and ranks on cards of their own over
NCCL. For ``halo`` and ``gather`` each rank writes its rows into their
zeroed place in one buffer and the buffer is summed over the group, as
int32 words of the rows' bytes: x + 0 is x's bit pattern in every dtype
(-0.0 and NaN included). Every rank, an empty one too, joins every
exchange with a buffer of the same size, which follows from the bounds
and the rows' trailing shape alone. Under NCCL a gather moves about
twice the bytes of an ``all_gather`` (ROADMAP). ``sum`` is a real f32
sum, the one exchange whose result depends on the split: the slabs'
partial sums add in another order than one rank's sum over the whole
grid, so the statistic may differ in its last bits. The ranks still
agree bit for bit: gloo's ring reduces each chunk once and passes the
result on to every rank.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """x's elements as a flat uint8 view of a contiguous copy."""
    return x.contiguous().reshape(-1).view(torch.uint8)


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

    def _sum(self, nbytes: int, parts, device) -> torch.Tensor:
        """A zeroed buffer of ``nbytes`` (rounded up to int32 words) on
        ``device`` with ``parts`` ((byte offset, uint8 tensor)) written
        in, summed over the group; returns its uint8 view. Every rank
        passes the same ``nbytes``; none at all skips the collective on
        every rank alike."""
        buf = torch.zeros(-(-nbytes // 4), dtype=torch.int32, device=device)
        raw = buf.view(torch.uint8)
        for off, part in parts:
            raw[off:off + part.numel()].copy_(part)
        self._reduce(buf)
        return raw

    def _reduce(self, buf: torch.Tensor) -> None:
        """``buf`` summed in place over the group; every exchange's one
        collective (none for an empty buffer, on every rank alike)."""
        if buf.numel():
            dist.all_reduce(buf, group=self.group)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in f32 summed over the group, the same on every rank;
        every rank joins with a tensor of x's shape (an empty slab's
        zeros). A group of one returns x in f32."""
        out = x.float().contiguous()
        if self.alone:
            return out
        out = out.clone()
        self._reduce(out)
        return out

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
        if len(self.bounds) == 1:
            return x
        xm = x.movedim(dim, 0)
        rest = xm.shape[1:]
        per = math.prod(rest) * x.element_size() * unit   # bytes per row
        raw = self._sum(per * self.total,
                        [(per * self.start, _bytes(xm))], x.device)
        whole = raw[:per * self.total].view(x.dtype).reshape(
            self.total * unit, *rest)
        return whole.movedim(0, dim).contiguous()

    def reach(self, k: int) -> List[Tuple[int, int]]:
        """The rows that the halos of ``k`` read, as disjoint runs in
        order: the ``k`` rows above and below each non-empty slab, within
        the grid (the layout of ``halo``'s buffer)."""
        spans = sorted(s for a, b in self.bounds if b > a
                       for s in ((max(a - k, 0), a),
                                 (b, min(b + k, self.total))) if s[1] > s[0])
        runs: List[Tuple[int, int]] = []
        for a, b in spans:
            if runs and a <= runs[-1][1]:
                runs[-1] = (runs[-1][0], max(runs[-1][1], b))
            else:
                runs.append((a, b))
        return runs

    def halo(self, x: torch.Tensor, k: int,
             dim: int = 1) -> Tuple[torch.Tensor, int]:
        """``x`` extended along ``dim`` by the ``k`` rows of the grid
        before it and after it, from whichever ranks hold them, cut short
        at the grid's edges; returns (extended, rows added before). Each
        rank writes its rows that any halo reads (``reach``) into one
        buffer; an empty slab writes nothing and gets (x, 0)."""
        dim = dim % x.dim()
        if k == 0 or len(self.bounds) == 1:
            return x, 0
        xm = x.movedim(dim, 0)
        rest = xm.shape[1:]
        per = math.prod(rest) * x.element_size()          # bytes per row
        runs, parts, at = [], [], 0
        for a, b in self.reach(k):       # each run's first row in the buffer
            lo, hi = max(a, self.start), min(b, self.stop)
            if hi > lo:
                parts.append((per * (at + lo - a),
                              _bytes(xm[lo - self.start:hi - self.start])))
            runs.append((a, b, at))
            at += b - a
        raw = self._sum(per * at, parts, x.device)
        if not self.size:
            return x, 0

        def rows(lo, hi):                # the grid's rows lo:hi
            a, _, off = next(r for r in runs if r[0] <= lo and hi <= r[1])
            p = raw[per * (off + lo - a):per * (off + hi - a)]
            return p.view(x.dtype).reshape(hi - lo, *rest).movedim(0, dim)
        top = min(k, self.start)
        bottom = min(k, self.total - self.stop)
        ext = ([rows(self.start - top, self.start)] if top else []) + [x] + (
            [rows(self.stop, self.stop + bottom)] if bottom else [])
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
