"""The sequence-sharded forward (port of streamflow_tpu/parallel/seq.py):
one clip's forward with the image's H axis split over the ranks of a seq
group, and the batch over the data axis, as JAX's
``make_seq_sharded_forward`` (``seq.py:22-51``).

JAX lets GSPMD partition the whole forward; here each layer runs on its
rank's slab of rows and the exchanges are written by hand
(``parallel/exchange.py``: halo rows from the neighbours, the whole grid
gathered from every slab). The numerics are the unsharded model's: every
op is either per row (per token, per pixel) or reads its neighbours'
rows through a halo or the whole grid through a gather, so each output
row is computed from the same values as on one rank.

Layer by layer (canonical StreamFlow only: ``twins_csc`` +
``sk_tam_v3`` + GMA, any T, every ``dw_impl``, f32 or bf16):

- Encoders (``layers/twins.py``) on slabs of Twins_CSC's stacked token
  grid (the T frames stacked along the height). A slab boundary falls on
  a multiple of ``encoder_unit()`` stage-2 rows (28: the 7-row LGA
  windows and the 4-row GSA cells of stage 2; stage 1's 7 and 8 at twice
  the rows), so the patch embeds, LGA windows and GSA cells of a slab
  are the whole grid's and only the last slab pads its LGA windows. The
  PEG 3x3 conv takes a 1-row halo; GSA's reduced tokens (its ``sr`` conv
  and norm, on each slab) are gathered and projected to keys and values
  whole, and its queries attend to all of them, flash or not by the
  whole grid's token count. The encoders' outputs are gathered whole.
- Hand-off: every rank builds the whole f2 pyramid and GMA's q and k
  from the whole context, and keeps its decoder rows (an even split of
  each frame pair's 1/8 grid) of f1, the context and q; its coordinates
  are the global ones of those rows.
- Refinement: K1 looks up its slab's queries in the whole pyramid; GMA's
  motion features are gathered every iteration and projected to v
  whole, and K3 runs the slab's queries against k and v; each SK block
  and the mask head run on their input's slab extended by their halo (7
  rows for the 15x15 depthwise conv, 3 for the gru's 7x7, 1 for the 3x3)
  and are cropped; the temporal layer is per pixel.
- Output: the convex upsampling reads a 1-row halo of the flow; the
  upsampled rows are gathered, so every rank of a seq group returns the
  whole flows of its data rows (JAX's ``out_sh = P("data")``).

Where a layer's shape follows the slab, the card's libraries may sum in
another order; so each product that takes a whole grid's worth of rows
runs at the whole grid's shape (GSA's kv, GMA's q, k and v; the ``sr``
conv on the slab padded to the whole grid's rows). On an H100 the f32
forward then equals the one-rank forward bit for bit (chip_smoke.py
phase 39).

Test mode only, as JAX's. The kernels are the unsharded path's own, at
the slabs' shapes; a CPU tensor takes their plain versions as it does
there. Nothing falls back to the unsharded forward: a group of one runs
this code with no exchange, bit for bit the unsharded forward.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

from streamflow_tpu_torch.config import CNN_ENCODERS
from streamflow_tpu_torch.layers.twins import SVT_LARGE, TwinsEncoder
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
           "SeqPlan"]

Bounds = List[Tuple[int, int]]


class SeqPlan(NamedTuple):
    """Every rank's (start, stop) rows: of the fnet's and the cnet's
    stacked stage-2 token grids (T and T-1 frames of H/8 rows), and of
    each frame pair's 1/8 grid in the decoder."""
    fnet: Bounds
    cnet: Bounds
    decoder: Bounds


def encoder_unit(cfg=SVT_LARGE) -> int:
    """Stage-2 stacked rows between two slab boundaries of the encoder:
    where the windows (ws), the GSA cells (sr) and, in stage 1, the stage-2
    patches of the unsharded grid start (28 for SVT-Large)."""
    (p1, p2), ws, (sr1, sr2) = (cfg["patch_sizes"], cfg["ws"],
                                cfg["sr_ratios"])
    stage1 = math.lcm(ws, sr1, p2)        # in stage-1 rows
    return math.lcm(-(-stage1 // p2), ws, sr2)


def _halo(cfg) -> int:
    """The decoder's largest halo: rows its widest conv reaches."""
    return max(sum(k // 2 for k in ks)
               for ks in (cfg.k_conv, cfg.pc_updater_conv, (3,)))


def seq_plan(t: int, height: int, width: int, n_seq: int,
             halo: int = 7) -> SeqPlan:
    """The slabs of a T=t clip of height x width over ``n_seq`` ranks.
    The decoder splits each pair's H/8 rows as evenly as possible (55:
    28, 27); each encoder splits its stacked grid into runs of
    ``encoder_unit()`` rows, as evenly as possible, the last slab taking
    the rest. Raises a ValueError, naming the shape and the constraint,
    where no plan exists: H or W not a multiple of 8, a decoder slab
    thinner than ``halo`` rows, or an encoder with fewer units than
    ranks."""
    if height % 8 or width % 8 or min(height, width, t) < 1:
        raise ValueError(f"seq_plan: {height}x{width} is not a multiple of "
                         f"8 (pad the clip, ops/padding.py)")
    if t < 2:
        raise ValueError(f"seq_plan: T={t}; a clip has two frames or more")
    h, unit = height // 8, encoder_unit()
    decoder = even_split(h, n_seq)
    if min(b - a for a, b in decoder) < halo:
        raise ValueError(
            f"seq_plan: {height}x{width} over n_seq={n_seq} gives decoder "
            f"slabs of {[b - a for a, b in decoder]} rows of its {h}-row "
            f"1/8 grid, thinner than the {halo}-row halo of its widest "
            f"conv; take fewer ranks or a taller clip")

    def encoder(frames):
        rows = frames * h
        units = -(-rows // unit)
        if units < n_seq:
            raise ValueError(
                f"seq_plan: the {frames}-frame stacked grid of a T={t} "
                f"{height}x{width} clip has {rows} stage-2 rows, "
                f"{units} slab(s) of {unit} rows (LGA windows and GSA "
                f"cells), fewer than n_seq={n_seq}")
        return [(a * unit, min(b * unit, rows))
                for a, b in even_split(units, n_seq)]
    return SeqPlan(encoder(t), encoder(t - 1), decoder)


def _check_model(model) -> None:
    """The canonical StreamFlow only; every other model raises, naming
    the ROADMAP entry that queues it."""
    if not isinstance(model, StreamFlow):
        raise NotImplementedError(
            f"make_seq_sharded_forward: {type(model).__name__} (the "
            f"two-frame models) is not sharded yet; ROADMAP.md A10f")
    cfg = model.cfg
    if cfg.encoder == "umt":
        raise NotImplementedError(
            "make_seq_sharded_forward: encoder='umt' (K3 over the ViT's "
            "tokens, gathered per block) is not sharded yet; ROADMAP.md "
            "A10e")
    if cfg.encoder in CNN_ENCODERS:
        raise NotImplementedError(
            f"make_seq_sharded_forward: encoder={cfg.encoder!r} (the CNN "
            f"encoders: instance-norm statistics over the seq group) is "
            f"not sharded yet; ROADMAP.md A10d")
    if cfg.encoder != "twins_csc" or cfg.update_block != "sk_tam_v3" or (
            not cfg.use_gma):
        raise NotImplementedError(
            f"make_seq_sharded_forward: encoder={cfg.encoder!r}, "
            f"update_block={cfg.update_block!r}, use_gma={cfg.use_gma} "
            f"(the per-frame Twins family, twins_3dconv's 3x3x3 halo, the "
            f"decoder ablations) is not sharded yet; only the canonical "
            f"twins_csc + sk_tam_v3 + GMA is; ROADMAP.md A10c")


def _frames(x: torch.Tensor, start: int, per_frame: int) -> torch.Tensor:
    """A slab (B, rows, W, C) of stacked rows from ``start``, as the
    patch embed takes it: (B, frames, per_frame, W, C) where it holds
    whole frames (the unsharded encoder's shapes), else (B, 1, rows, W,
    C) (a stride-p conv of whole p-row cells gives the same rows)."""
    b, rows = x.shape[:2]
    if start % per_frame == 0 and rows % per_frame == 0:
        return x.reshape(b, rows // per_frame, per_frame, *x.shape[2:])
    return x.reshape(b, 1, *x.shape[1:])


def _encode(enc: TwinsEncoder, x: torch.Tensor, rows2: Rows) -> torch.Tensor:
    """TwinsEncoder.forward of Twins_CSC on this rank's slab ``rows2`` of
    the stacked stage-2 grid of x (B, T, H, W, 3); returns the whole
    output (B, T, H/8, W/8, C), gathered."""
    b, t, height, width, c_in = x.shape
    svt = enc.svt
    p1, p2 = (pe.proj.stride[0] for pe in svt.patch_embeds)
    rows1 = Rows([(a * p2, e * p2) for a, e in rows2.bounds], rows2.index,
                 rows2.group)
    scale = p1 * p2
    stacked = x.reshape(b, t * height, width, c_in)
    slab = _frames(stacked[:, rows2.start * scale:rows2.stop * scale],
                   rows2.start * scale, height)
    per_frame = height
    for i, rows in enumerate((rows1, rows2)):
        tok, size = svt.patch_embeds[i](slab)
        assert size[0] == rows.size, (size, rows.bounds)
        lga, gsa = svt.blocks[i]
        tok = svt.pos_block[i](lga(tok, size), size, rows)
        tok = gsa(tok, size, enc.gsa_flash, rows=rows)
        per_frame //= (p1, p2)[i]
        slab = _frames(tok.reshape(b, *size, -1), rows.start, per_frame)
    out = rows2.gather(slab.reshape(b, rows2.size, *slab.shape[3:]), 1)
    return out.reshape(b, t, per_frame, *out.shape[2:])


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
    fmaps = _encode(model.fnet, x, Rows(plan.fnet, index, group))
    cnets = _encode(model.cnet, x[:, :-1], Rows(plan.cnet, index, group))
    dec = Rows(plan.decoder, index, group)
    r0, r1 = dec.start, dec.stop
    h, w, c = fmaps.shape[2:]
    hs = dec.size
    pyramid = FusedCorr(fmaps[:, :-1, r0:r1].reshape(b * f, hs, w, c),
                        fmaps[:, 1:].reshape(b * f, h, w, c),
                        cfg.corr_levels, cfg.corr_radius)
    net, inp = cnets.split(cfg.hidden_dim, dim=-1)
    net, inp = torch.tanh(net), torch.relu(inp)
    # GMA's q and k of the whole grid, as on one rank; the slab's queries
    q, k = model.att(inp.reshape(b * f, h, w, cfg.context_dim))
    q = q.reshape(*q.shape[:2], h, w, -1)[:, :, r0:r1]
    attn = (q.reshape(*k.shape[:2], hs * w, -1).contiguous(), k)
    net, inp = net[:, :, r0:r1], inp[:, :, r0:r1]

    coords0 = coords_grid(b * f, hs, w, images.device, y0=r0).reshape(
        b, f, hs, w, 2)
    coords1 = coords0
    mask = None
    for i in range(iters):
        corr = pyramid.lookup(coords1.reshape(b * f, hs, w, 2))
        net, m, delta = model.update_block(
            net, inp, corr.reshape(b, f, hs, w, -1), coords1 - coords0,
            attn, compute_mask=i == iters - 1, rows=dec)
        if m is not None:
            mask = m
        coords1 = coords1 + delta.float()
    if mask is None:
        mask = coords1.new_zeros(b, f, hs, w, 9 * cfg.ratio ** 2)
    flow, top = dec.halo((coords1 - coords0).reshape(b * f, hs, w, 2), 1)
    up = convex_upsample(flow, mask.reshape(b * f, hs, w, -1), cfg.ratio,
                         top)
    up = up.reshape(b, f, *up.shape[1:])
    return dec.gather(up, 2, unit=cfg.ratio)


def make_seq_sharded_forward(model, mesh, iters=None):
    """The test-mode forward of ``model`` with the image's H axis split
    over the seq axis of ``mesh`` and the batch over its data axis.
    Returns ``run(images)``: images (B, T, H, W, 3) in [0, 255], the
    global batch, the same on every rank, H and W multiples of 8 -> this
    rank's data rows of the flows, (B / n_data, T-1, H, W, 2) f32, whole
    in H and W on every rank of its seq group.

    ``mesh`` is ``make_mesh(n_data, n_seq)``'s: a ``SeqMesh``, or for
    n_seq = 1 the data group (None in a single process), where each rank
    runs its rows whole. The parameters are the model's own, broadcast
    once from rank 0 (``replicate``). The canonical StreamFlow only
    (``twins_csc`` + ``sk_tam_v3`` + GMA, any T, every ``dw_impl``, f32
    or bf16); any other model raises a NotImplementedError naming its
    ROADMAP entry."""
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
    halo = _halo(model.cfg)
    device = next(model.parameters()).device

    def run(images):
        bsz, t, height, width = images.shape[:4]
        if bsz % n_data:
            raise ValueError(f"make_seq_sharded_forward: a batch of {bsz} "
                             f"rows, not a multiple of n_data={n_data}")
        plan = seq_plan(t, height, width, n_seq, halo)
        rows = bsz // n_data
        local = images[d * rows:(d + 1) * rows].to(device)
        return _forward(model, local, n_iters, plan, s, group)

    return run
