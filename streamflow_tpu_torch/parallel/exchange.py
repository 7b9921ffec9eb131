"""Row exchanges of the sequence-sharded forward (``parallel/seq.py``): a
grid split along its rows into contiguous slabs, one per rank of a seq
group, and the two exchanges its layers need.

- ``halo``: a slab extended by ``k`` rows of each neighbour, for a layer
  whose window reaches ``k`` rows across a slab edge (a kxk conv reaches
  k // 2). A slab at the grid's own edge gets nothing there: the layer
  pads that edge as it does on the whole grid.
- ``gather``: the whole grid from every rank's slab, for a layer that
  needs it all (attention keys and values, the correlation pyramid, the
  output). Slabs may differ in size.

Both are carried by ``all_reduce``, the collective that gloo also runs on
CUDA tensors (with ``broadcast``), so the same code runs two ranks that
share one card over gloo and ranks on cards of their own over NCCL. Each
rank writes its rows into its own zeroed slot of one buffer and the
buffer is summed over the group, as int32 words of the rows' bytes: x +
0 is x's bit pattern in every dtype (-0.0 and NaN included). Under NCCL
this moves about twice the bytes of an ``all_gather`` (ROADMAP).
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

    def coarse(self, div: int) -> "Rows":
        """The same split of the grid subsampled by ``div`` (a stride-div
        conv without padding): rank r's rows start // div to stop // div.
        Exact where every start is a multiple of div."""
        return Rows([(a // div, b // div) for a, b in self.bounds],
                    self.index, self.group)

    def _sum(self, nbytes: int, parts) -> torch.Tensor:
        """A zeroed buffer of ``nbytes`` (rounded up to int32 words) with
        ``parts`` ((byte offset, uint8 tensor)) written in, summed over
        the group; returns its uint8 view."""
        dev = parts[0][1].device if parts else None
        buf = torch.zeros(-(-nbytes // 4), dtype=torch.int32, device=dev)
        raw = buf.view(torch.uint8)
        for off, part in parts:
            raw[off:off + part.numel()].copy_(part)
        dist.all_reduce(buf, group=self.group)
        return raw

    def gather(self, x: torch.Tensor, dim: int = 1,
               unit: int = 1) -> torch.Tensor:
        """The whole grid, contiguous, from this rank's slab ``x`` along
        ``dim``: (stop - start) * ``unit`` entries there (``unit`` > 1 for
        an axis of rows x columns flattened, or of rows upsampled)."""
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
                        [(per * self.start, _bytes(xm))])
        whole = raw[:per * self.total].view(x.dtype).reshape(
            self.total * unit, *rest)
        return whole.movedim(0, dim).contiguous()

    def halo(self, x: torch.Tensor, k: int,
             dim: int = 1) -> Tuple[torch.Tensor, int]:
        """``x`` extended along ``dim`` by the ``k`` rows before it (the
        previous rank's last) and after it (the next rank's first), where
        those ranks exist; returns (extended, rows added before)."""
        dim = dim % x.dim()
        n = len(self.bounds)
        if k == 0 or n == 1:
            return x, 0
        if min(b - a for a, b in self.bounds) < k:
            raise ValueError(f"Rows.halo: a slab of {self.bounds} is "
                             f"thinner than the halo of {k} rows")
        xm = x.movedim(dim, 0)
        per = xm[:k].numel() * x.element_size()            # bytes per part
        slot = lambda r, side: (2 * r + side) * per  # noqa: E731
        raw = self._sum(2 * n * per, [
            (slot(self.index, 0), _bytes(xm[:k])),
            (slot(self.index, 1), _bytes(xm[xm.shape[0] - k:]))])

        def part(r, side):
            p = raw[slot(r, side):slot(r, side) + per].view(x.dtype)
            return p.reshape(k, *xm.shape[1:]).movedim(0, dim)
        parts = [x]
        top = 0
        if self.index > 0:
            parts.insert(0, part(self.index - 1, 1))
            top = k
        if self.index < n - 1:
            parts.append(part(self.index + 1, 0))
        return torch.cat(parts, dim=dim), top

    def local(self, fn: Callable, x: torch.Tensor, k: int,
              dim: int = 1) -> torch.Tensor:
        """``fn`` (a layer that reaches ``k`` rows across a slab edge,
        along ``dim`` of its input and output) on this rank's slab: run on
        the slab extended by its halo, cropped back to the slab's rows."""
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
