"""The sequence-sharded forward (port of streamflow_tpu/parallel/seq.py):
one clip's forward with the image's H axis split over the ranks of a seq
group, and the batch over the data axis, as JAX's
``make_seq_sharded_forward`` (``seq.py:22-51``).

JAX lets GSPMD partition the whole forward; here each layer runs on its
rank's slab of rows and the exchanges are written by hand, with the
collectives GSPMD inserts (``parallel/exchange.py``: halo rows by
point-to-point sends from whichever ranks hold them, the whole grid by
an all_gather of every slab, statistics by an all_reduce). The numerics are the unsharded
model's: every op is either per row (per token, per pixel) or reads its
neighbours' rows through a halo or the whole grid through a gather, so
each output row is computed from the same values as on one rank.

Every Twins StreamFlow (``twins_csc``, ``twins``, ``twins_1dconv``,
``twins_temporal_attention``, ``twins_3dconv``; ``sk_tam_v3``,
``sk_tam_v1``, ``sk_tam_v3_noinit``; with or without GMA), any T >= 2,
every ``dw_impl``, f32 or bf16, H and W multiples of 8, any n_seq and
n_data, any batch. Slabs may be thinner than a halo, or empty where a
grid has fewer rows (or encoder units) than ranks: an empty slab runs no
layer on its rows and launches no kernel, and joins every exchange in
the same order. Layer by layer:

- Encoders (``layers/twins.py``). Twins_CSC: slabs of its stacked token
  grid (the T frames stacked along the height). The per-frame encoders:
  slabs of each frame's rows, the same rows in every frame (the frames
  folded into the batch, as ``TwinsEncoder.forward``), so that the
  hooks, per token over the T frames (``"attn"``: TinyAttention over T;
  ``"1dconv"``: a Conv1d over T), run on the slab. A slab boundary falls
  on a multiple of ``encoder_unit()`` stage-2 rows (28: the 7-row LGA
  windows and the 4-row GSA cells of stage 2; stage 1's 7 and 8 at twice
  the rows), so the patch embeds, LGA windows and GSA cells of a slab
  are the whole grid's, only the last slab pads its LGA windows, and no
  window or cell needs a halo. The PEG 3x3 conv takes a 1-row halo (per
  frame); GSA's reduced tokens (its ``sr`` conv and norm, on each slab)
  are gathered and projected to keys and values whole, and its queries
  attend to all of them, flash or not by the whole grid's token count
  (one frame's, per frame: stage 1 takes K3 at 440x1024, stage 2 not).
  The encoders' outputs are gathered whole; ``twins_3dconv``'s 3x3x3
  ``temporal_conv`` over (T, H, W) then runs on the whole output on
  every rank (at the unsharded shape: no halo over T and H, the same
  sums as on one rank).
- Hand-off: every rank builds the whole f2 pyramid and GMA's q and k
  from the whole context, and keeps its decoder rows (an even split of
  each frame pair's 1/8 grid) of f1, the context and q; its coordinates
  are the global ones of those rows.
- Refinement: K1 looks up its slab's queries in the whole pyramid; GMA's
  motion features are gathered every iteration and projected to v
  whole, and K3 runs the slab's queries against k and v (without GMA,
  the motion features stand in); each SK block and the mask head run on
  their input's slab extended by their halo (7 rows for the 15x15
  depthwise conv, 3 for the gru's 7x7, 1 for the 3x3), from as many
  ranks as hold those rows, and are cropped; the temporal layer is per
  pixel (live under ``sk_tam_v3_noinit``), the flow head joint or per
  frame (``sk_tam_v1``).
- Output: the convex upsampling reads a 1-row halo of the flow; the
  upsampled rows are gathered, so every rank of a seq group returns the
  whole flows of its data rows.

Where a layer's shape follows the slab, the card's libraries may sum in
another order; so each product that takes a whole grid's worth of rows
runs at the whole grid's shape (GSA's kv, GMA's q, k and v, the temporal
layer; the ``sr`` conv on the slab padded to the whole grid's rows). On
an H100 the canonical f32 forward then equals the one-rank forward bit
for bit (chip_smoke.py phase 39).

Test mode only, as JAX's. The kernels are the unsharded path's own, at
the slabs' shapes; a CPU tensor takes their plain versions as it does
there. Nothing falls back to the unsharded forward: a group of one runs
this code with no exchange, bit for bit the unsharded forward.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import torch

from streamflow_tpu_torch.config import CNN_ENCODERS
from streamflow_tpu_torch.layers.twins import SVT_LARGE, TwinsEncoder
from streamflow_tpu_torch.layers.umt import UMT
from streamflow_tpu_torch.models.streamflow import StreamFlow
from streamflow_tpu_torch.ops.coords import coords_grid
from streamflow_tpu_torch.ops.kernels.corr_lookup import FusedCorr
from streamflow_tpu_torch.ops.upsample import convex_upsample
from streamflow_tpu_torch.parallel.exchange import Rows, even_split
from streamflow_tpu_torch.parallel.mesh import SeqMesh, replicate
from streamflow_tpu_torch.parallel.multihost import (is_initialized,
                                                     process_count,
                                                     process_index)

__all__ = ["make_seq_sharded_forward", "seq_plan", "encoder_unit",
           "encoder_kind", "SeqPlan"]

Bounds = List[Tuple[int, int]]


class SeqPlan(NamedTuple):
    """Every rank's (start, stop) rows, in rank order: of the fnet's and
    the cnet's output grids (Twins_CSC: the stacked stage-2 grids of the T
    and T-1 frames; a per-frame Twins encoder or a CNN encoder: each
    frame's H/8 rows; UMT: each frame's H/16 rows; a per-frame slab is
    the same rows of every frame), and of each frame pair's grid at the
    model's ratio in the decoder. A slab may be empty."""
    fnet: Bounds
    cnet: Bounds
    decoder: Bounds

    def holds(self, s: int) -> Dict[str, int]:
        """Rank ``s``'s rows of each grid (none: it runs no layer there
        and launches none of that grid's kernels)."""
        return {name: b - a for name, (a, b) in
                zip(self._fields, (bounds[s] for bounds in self))}


def encoder_unit(cfg=SVT_LARGE) -> int:
    """Stage-2 rows between two slab boundaries of the encoder: where the
    windows (ws), the GSA cells (sr) and, in stage 1, the stage-2 patches
    of the unsharded grid start (28 for SVT-Large)."""
    (p1, p2), ws, (sr1, sr2) = (cfg["patch_sizes"], cfg["ws"],
                                cfg["sr_ratios"])
    stage1 = math.lcm(ws, sr1, p2)        # in stage-1 rows
    return math.lcm(-(-stage1 // p2), ws, sr2)


def encoder_kind(encoder: str) -> str:
    """The planner's kind of a config's encoder: "twins", "cnn" (the RAFT
    CNN per frame, Res18_3D) or "umt"."""
    if encoder == "umt":
        return "umt"
    return "cnn" if encoder in CNN_ENCODERS else "twins"


def seq_plan(t: int, height: int, width: int, n_seq: int,
             temporal: bool = True, kind: str = "twins") -> SeqPlan:
    """The slabs of a T=t clip of height x width over ``n_seq`` ranks.
    The decoder splits each pair's H/8 rows (H/16 under UMT) as evenly as
    possible (55 in 2: 28, 27; 55 in 8: seven of 7, one of 6; 6 in 8: six
    of 1, two empty). A Twins encoder (``kind`` "twins") splits its grid
    (``temporal``: Twins_CSC's stacked T-frame grid; else one frame's H/8
    rows) into whole runs of ``encoder_unit()`` rows, as evenly as
    possible, the last slab taking the rest; where the grid has fewer
    units than ranks, the ranks past them get empty slabs. Whole units
    rather than cuts through windows and cells completed by halos: no
    layer of the encoder then exchanges more than PEG's 1-row halo and
    GSA's gather, and each window and cell is summed at the unsharded
    grid's place. The CNN encoders ("cnn") have no windows or cells: they
    split each frame's H/8 rows as the decoder does (their convs take
    halos at every stride); UMT ("umt") splits each frame's H/16 rows,
    its 16-row patches, likewise. Raises a ValueError, naming the shape,
    for H or W not a multiple of 8 (16 under UMT) or T < 2."""
    ratio = 16 if kind == "umt" else 8
    if height % ratio or width % ratio or min(height, width, t) < 1:
        raise ValueError(f"seq_plan: {height}x{width} is not a multiple of "
                         f"{ratio} (pad the clip, ops/padding.py)")
    if t < 2:
        raise ValueError(f"seq_plan: T={t}; a clip has two frames or more")
    if n_seq < 1:
        raise ValueError(f"seq_plan: n_seq={n_seq}")
    h, unit = height // ratio, encoder_unit()
    if kind != "twins":
        split = even_split(h, n_seq)
        return SeqPlan(split, split, split)

    def encoder(rows):
        return [(min(a * unit, rows), min(b * unit, rows))
                for a, b in even_split(-(-rows // unit), n_seq)]
    if temporal:
        return SeqPlan(encoder(t * h), encoder((t - 1) * h),
                       even_split(h, n_seq))
    return SeqPlan(encoder(h), encoder(h), even_split(h, n_seq))


def _check_model(model) -> None:
    """Every StreamFlow; the two-frame models raise, naming the ROADMAP
    entry that keeps them out (JAX's version cannot run them either)."""
    if not isinstance(model, StreamFlow):
        raise NotImplementedError(
            f"make_seq_sharded_forward: {type(model).__name__} (the "
            f"two-frame models) is not sharded; ROADMAP.md A10f")


def _frames(x: torch.Tensor, start: int, per_frame: int) -> torch.Tensor:
    """A slab (B, rows, W, C) of stacked rows from ``start``, as the
    patch embed takes it: (B, frames, per_frame, W, C) where it holds
    whole frames (the unsharded encoder's shapes), else (B, 1, rows, W,
    C) (a stride-p conv of whole p-row cells gives the same rows)."""
    b, rows = x.shape[:2]
    if rows and start % per_frame == 0 and rows % per_frame == 0:
        return x.reshape(b, rows // per_frame, per_frame, *x.shape[2:])
    return x.reshape(b, 1, *x.shape[1:])


def _encode(enc: TwinsEncoder, x: torch.Tensor, rows2: Rows) -> torch.Tensor:
    """TwinsEncoder.forward on this rank's slab ``rows2`` of the encoder's
    stage-2 grid (``SeqPlan``) of x (B, T, H, W, 3); returns the whole
    output (B, T, H/8, W/8, C), gathered."""
    b, t, height, width, c_in = x.shape
    svt = enc.svt
    p1, p2 = (pe.proj.stride[0] for pe in svt.patch_embeds)
    rows1 = rows2.fine(p2)
    scale = p1 * p2
    if enc.temporal:     # Twins_CSC: slabs of the stacked grid
        stacked = x.reshape(b, t * height, width, c_in)
        slab = _frames(stacked[:, rows2.start * scale:rows2.stop * scale],
                       rows2.start * scale, height)
        batch, t_hook = b, 1
    else:                # the same rows of every frame, frames in the batch
        slab = x[:, :, rows2.start * scale:rows2.stop * scale].reshape(
            b * t, 1, rows2.size * scale, width, c_in)
        batch, t_hook = b * t, t if enc.hook != "none" else 1
    per_frame = height
    for i, rows in enumerate((rows1, rows2)):
        tok, size = svt.patch_embeds[i](slab)
        assert size[0] == rows.size, (size, rows.bounds)
        lga, gsa = svt.blocks[i]
        tok = svt.pos_block[i](lga(tok, size, t=t_hook), size, rows)
        tok = gsa(tok, size, enc.gsa_flash, t=t_hook, rows=rows)
        per_frame //= (p1, p2)[i]
        tok = tok.reshape(batch, *size, tok.shape[-1])
        slab = (_frames(tok, rows.start, per_frame) if enc.temporal
                else tok.reshape(batch, 1, *tok.shape[1:]))
    out = rows2.gather(slab.reshape(batch, rows2.size, *slab.shape[3:]), 1)
    return enc.conv3d(out.reshape(b, t, per_frame, *out.shape[2:]))


def _encode_cnn(enc, x: torch.Tensor, rows: Rows) -> torch.Tensor:
    """A CNN encoder (``PerFrameBasicEncoder``, ``Res18_3D``) on this
    rank's slab ``rows`` of each frame's H/8 rows, the frames' input rows
    8 times those, in the batch; returns the whole output (B, T, H/8,
    W/8, C), gathered."""
    fine = rows.fine(8)
    return rows.gather(enc(x[:, :, fine.start:fine.stop], rows=fine), 2)


def _encode_umt(enc: UMT, x: torch.Tensor, rows: Rows) -> torch.Tensor:
    """UMT on this rank's slab ``rows`` of each frame's H/16 token rows
    (``layers/umt.py``: keys and values gathered whole in every block);
    returns the whole output (B, T, H/16, W/16, 768), gathered."""
    fine = rows.fine(16)
    return rows.gather(enc(x[:, :, fine.start:fine.stop], rows=rows), 2)


ENCODE = {"twins": _encode, "cnn": _encode_cnn, "umt": _encode_umt}


@torch.no_grad()
def _forward(model: StreamFlow, images: torch.Tensor, iters: int,
             plan: SeqPlan, index: int, group) -> torch.Tensor:
    """StreamFlow's test-mode forward (``models/streamflow.py::_run``) on
    this rank's slabs; returns the whole flows (B, T-1, H, W, 2) f32."""
    cfg = model.cfg
    b, t = images.shape[:2]
    f = t - 1
    assert t == cfg.T, f"model is configured for T={cfg.T}, got {t}"
    x = (2.0 * (images.float() / 255.0) - 1.0).to(model.dtype)
    encode = ENCODE[encoder_kind(cfg.encoder)]
    fmaps = encode(model.fnet, x, Rows(plan.fnet, index, group))
    cnets = encode(model.cnet, x[:, :-1], Rows(plan.cnet, index, group))
    dec = Rows(plan.decoder, index, group)
    r0, r1 = dec.start, dec.stop
    h, w, c = fmaps.shape[2:]
    hs = dec.size
    pyramid = FusedCorr(fmaps[:, :-1, r0:r1].reshape(b * f, hs, w, c),
                        fmaps[:, 1:].reshape(b * f, h, w, c),
                        cfg.corr_levels, cfg.corr_radius)
    net, inp = cnets.split(cfg.hidden_dim, dim=-1)
    net, inp = torch.tanh(net), torch.relu(inp)
    attn = None
    if model.att is not None:
        # GMA's q and k of the whole grid, as on one rank; the slab's
        # queries
        q, k = model.att(inp.reshape(b * f, h, w, cfg.context_dim))
        q = q.reshape(*q.shape[:2], h, w, q.shape[-1])[:, :, r0:r1]
        attn = (q.reshape(*k.shape[:2], hs * w, k.shape[-1]).contiguous(),
                k)
    net, inp = net[:, :, r0:r1], inp[:, :, r0:r1]

    coords0 = coords_grid(b * f, hs, w, images.device, y0=r0).reshape(
        b, f, hs, w, 2)
    coords1 = coords0
    mask = None
    for i in range(iters):
        corr = pyramid.lookup(coords1.reshape(b * f, hs, w, 2))
        net, m, delta = model.update_block(
            net, inp, corr.reshape(b, f, hs, w, corr.shape[-1]),
            coords1 - coords0, attn, compute_mask=i == iters - 1, rows=dec)
        if m is not None:
            mask = m
        coords1 = coords1 + delta.float()
    if mask is None:
        mask = coords1.new_zeros(b, f, hs, w, 9 * cfg.ratio ** 2)
    flow, top = dec.halo((coords1 - coords0).reshape(b * f, hs, w, 2), 1)
    up = convex_upsample(flow, mask.reshape(b * f, hs, w, mask.shape[-1]),
                         cfg.ratio, top)
    up = up.reshape(b, f, *up.shape[1:])
    return dec.gather(up, 2, unit=cfg.ratio)


def make_seq_sharded_forward(model, mesh, iters=None):
    """The test-mode forward of ``model`` with the image's H axis split
    over the seq axis of ``mesh`` and the batch over its data axis.
    Returns ``run(images)``: images (B, T, H, W, 3) in [0, 255], the
    global batch, the same on every rank, H and W multiples of 8 (of 16
    under UMT) -> this
    rank's data rows of the flows, (rows, T-1, H, W, 2) f32, whole in H
    and W on every rank of its seq group. Data rank d takes the rows
    ``even_split(B, n_data)[d]`` (B=3 over 2: 2 and 1; B=1 over 4: one
    and three groups of none, which return (0, T-1, H, W, 2) and
    exchange nothing): the data ranks' outputs, in order, are the
    global batch's flows, each row computed once. (JAX's GSPMD, asked
    for ``P("data")`` on a batch that n_data does not divide, keeps the
    output whole on every device instead: B=1, 3, 5 or 7 over 4, on
    JAX's CPU devices; the global array it returns is the same.)

    ``mesh`` is ``make_mesh(n_data, n_seq)``'s: a ``SeqMesh``, or for
    n_seq = 1 the data group (None in a single process), where each rank
    runs its rows whole. The parameters are the model's own, broadcast
    once from rank 0 (``replicate``). Every StreamFlow (the module
    docstring); the two-frame models raise a NotImplementedError naming
    ROADMAP.md A10f."""
    _check_model(model)
    if isinstance(mesh, SeqMesh):
        n_data, n_seq, d, s = mesh.n_data, mesh.n_seq, mesh.d, mesh.s
        group = mesh.seq_group
    elif mesh is None:
        if is_initialized() and process_count() > 1:
            raise ValueError("make_seq_sharded_forward: mesh None in a "
                             "group of several processes; pass make_mesh()")
        n_data, n_seq, d, s, group = 1, 1, 0, 0, None
    else:        # make_mesh(n_seq=1): the data group
        n_data, n_seq, s, group = process_count(), 1, 0, None
        d = process_index()
    replicate(model)
    n_iters = model.cfg.iters if iters is None else iters
    kind = encoder_kind(model.cfg.encoder)
    temporal = kind == "twins" and model.fnet.temporal
    device = next(model.parameters()).device

    def run(images):
        bsz, t, height, width = images.shape[:4]
        plan = seq_plan(t, height, width, n_seq, temporal, kind)
        a, e = even_split(bsz, n_data)[d]
        if a == e:       # none of the batch's rows: nothing to exchange
            return torch.zeros(0, t - 1, height, width, 2, device=device)
        return _forward(model, images[a:e].to(device), n_iters, plan, s,
                        group)

    return run
