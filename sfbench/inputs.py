"""What a run feeds both sides, made on the device from ``--seed``: the
weights (from the parameters' names and shapes alone) and the clips.

Weights: one normal draw for every parameter, then fan-in scaling: every
parameter of two or more dims r / sqrt(fan in), norm scales 1 + 0.1 r,
other vectors (biases, GMA's gamma) 0.05 r; BatchNorm running means
0.05 r and variances 1 + 0.1 |r|; the flow head's output layer times
FLOW_HEAD_SCALE, or the traffic's ``flow_head_scale``. Random weights
make a feedback loop through the flow input of the motion encoder: at
the fan-in scale the flows grow about 2.7x an iteration. The scaled flow
head keeps them in the range of real footage, tens of pixels. A training
mix scales it further down, so that a step's flows stay under its
targets, as a model's being fine-tuned do, and each clip's loss and
gradient follow its own targets rather than the model's own output.

Clips: a smooth random texture (bicubic upsampling of coarse noise, plus
finer noise) seen through a seeded camera motion: frame k samples the
texture at x - k u(x), with u a translation of up to ``max_disp`` px
plus a zoom of up to 2%, so that the flow from each frame to the next is
u. Every seed gives the same sizes.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch
import torch.nn.functional as F

from sfbench.reference.ops import coords_grid

FLOW_HEAD_SCALE = 2e-3
FLOW_HEAD = "update_block.flow_head.ffn2.2."
SEED_MOD = 2 ** 63 - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of draws of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * stream) % SEED_MOD)
    return g


def make_weights(specs: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                 device, head_scale: float = FLOW_HEAD_SCALE
                 ) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for each (name, shape)."""
    specs = list(specs)
    sizes = [math.prod(s) for _, s in specs]
    r = torch.randn(sum(sizes), generator=generator(seed, 0, device),
                    device=device)
    out = {}
    for (name, shape), x in zip(specs, r.split(sizes)):
        x = x.reshape(shape)
        last = name.rsplit(".", 1)[-1]
        if last == "running_mean":
            x = 0.05 * x
        elif last == "running_var":
            x = 1.0 + 0.1 * x.abs()
        elif len(shape) >= 2:
            x = x / math.sqrt(math.prod(shape[1:]))
        elif "norm" in name and last == "weight":
            x = 1.0 + 0.1 * x
        else:
            x = 0.05 * x
        if name.startswith(FLOW_HEAD):
            x = x * head_scale
        out[name] = x
    return out


def cell_weights(cell, specs, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``cell``'s runs: its traffic's flow head scale."""
    return make_weights(specs, seed, device, cell.traffic.get(
        "flow_head_scale", FLOW_HEAD_SCALE))


def served(weights: Dict[str, torch.Tensor], dtypes: Dict[str, torch.dtype]
           ) -> Dict[str, torch.Tensor]:
    """The weights as the program holds them (each rounded to its dtype),
    in float32: what the reference computes with."""
    return {k: v.to(dtypes[k]).float() for k, v in weights.items()}


def motion(n: int, h: int, w: int, max_disp: float, g, device):
    """(n, h, w, 2) flow fields: a translation of up to ``max_disp`` px and
    a zoom of up to 2% about the centre."""
    p = torch.rand(n, 3, generator=g, device=device) * 2 - 1
    centre = torch.tensor([(w - 1) / 2, (h - 1) / 2], device=device)
    rel = coords_grid(1, h, w, device)[0] - centre
    return (max_disp * p[:, None, None, :2]
            + 0.02 * p[:, None, None, 2:] * rel[None])


def clips(n: int, t: int, h: int, w: int, max_disp: float, seed: int,
          stream: int, device):
    """n clips (n, t, h, w, 3) in [0, 255] float32 and the flow of each
    (n, h, w, 2): frame k is the texture at x - k u(x)."""
    g = generator(seed, stream, device)
    margin = int(math.ceil(t * (max_disp + 0.02 * max(h, w)))) + 8
    ch, cw = h + 2 * margin, w + 2 * margin
    coarse = torch.randn(n, 3, ch // 16 + 2, cw // 16 + 2, generator=g,
                         device=device)
    tex = F.interpolate(coarse, size=(ch, cw), mode="bicubic",
                        align_corners=False)
    fine = torch.randn(n, 3, ch // 2, cw // 2, generator=g, device=device)
    tex = tex + 0.3 * F.interpolate(fine, size=(ch, cw), mode="bilinear",
                                    align_corners=False)
    tex = (127.5 + 60.0 * tex).clamp(0.0, 255.0)
    u = motion(n, h, w, max_disp, g, device)
    base = coords_grid(1, h, w, device) + margin
    frames = []
    for k in range(t):
        pos = base - k * u
        grid = torch.stack([2 * pos[..., 0] / (cw - 1) - 1,
                            2 * pos[..., 1] / (ch - 1) - 1], -1)
        frames.append(F.grid_sample(tex, grid, mode="bilinear",
                                    align_corners=True))
    video = torch.stack(frames, 1).permute(0, 1, 3, 4, 2).contiguous()
    return video, u


def pad_rows(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(..., h, w, 3) replicate-padded to (ph, pw), the rows split between
    top and bottom and the columns likewise (InputPadder's 'sintel'
    mode)."""
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    dh, dw = ph - h, pw - w
    y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.pad(y, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2),
              mode="replicate")
    return y.permute(0, 2, 3, 1).reshape(*lead, ph, pw, c)
