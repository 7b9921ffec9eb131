"""Sequence loss over refinement iterates (port of
streamflow_tpu/training/loss.py; reference train_mf.py:52-76):
gamma-weighted L1 across iterations, invalid pixels and displacements of
MAX_FLOW px or more excluded, the mean taken over ALL elements (masked
ones count as zero); EPE and the 1/3/5 px rates of the final iterate over
the valid pixels.

Shapes (channel-last): preds (I, B, H, W, 2) or (I, B, F, H, W, 2), gt
matching minus the leading I, valid (..., H, W).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

MAX_FLOW = 400.0


def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor,
                  valid: torch.Tensor, gamma: float = 0.8,
                  max_flow: float = MAX_FLOW, sums: bool = False
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics). With ``sums`` each metric is the pair (sum over
    the valid pixels, their count) that ``masked_means`` divides: the
    form a data-parallel step adds up over its ranks before it divides
    (training/step.py)."""
    n = flow_preds.shape[0]
    gt = flow_gt.float()
    mag = torch.sqrt((gt ** 2).sum(-1))
    vf = ((valid >= 0.5) & (mag < max_flow)).float()[..., None]

    weights = gamma ** torch.arange(n - 1, -1, -1, dtype=torch.float32,
                                    device=flow_preds.device)
    l1 = (flow_preds.float() - gt[None]).abs()
    per_iter = (vf[None] * l1).mean(dim=tuple(range(1, l1.ndim)))
    loss = (weights * per_iter).sum()

    with torch.no_grad():
        epe = torch.sqrt(((flow_preds[-1].float() - gt) ** 2).sum(-1))
        count = vf.sum()

        def masked(x):
            return (x[..., None] * vf).sum(), count

        metrics = {"epe": masked(epe), "1px": masked((epe < 1).float()),
                   "3px": masked((epe < 3).float()),
                   "5px": masked((epe < 5).float())}
    return loss, (metrics if sums else masked_means(metrics))


def masked_means(metrics: Dict) -> Dict[str, torch.Tensor]:
    """Each (sum, count) pair of ``sequence_loss(..., sums=True)`` as its
    mean over the valid pixels (a count below one taken as one); other
    entries as they are."""
    return {k: v[0] / v[1].clamp(min=1.0) if isinstance(v, tuple) else v
            for k, v in metrics.items()}
