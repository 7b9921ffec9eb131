"""Plain training step of a multi-frame model (the reference's
train_mf.py: sequence loss per frame pair, summed; backward; clipping by
the global norm; AdamW under the linear OneCycle schedule), over a dict of
float32 parameters.

``steps(ref, P, batches, cfg, hp, pr)`` runs len(batches) steps of the
model whose reference module is ``ref`` from the parameters P (left
untouched) and returns, per step, the loss and the clipped gradients of
step 1, and the parameters after the last step.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from sfbench.reference.ops import Prec

MAX_FLOW = 400.0


def sequence_loss(preds, gt, valid, gamma):
    """preds (I, B, H, W, 2), gt (B, H, W, 2), valid (B, H, W): the
    gamma-weighted L1 of every iterate over all elements, pixels invalid
    or moving MAX_FLOW px or more counted as zero."""
    n = preds.shape[0]
    vf = ((valid >= 0.5) & (gt.norm(dim=-1) < MAX_FLOW)).float()[..., None]
    loss = 0.0
    for i in range(n):
        loss = loss + gamma ** (n - 1 - i) * (vf * (preds[i] - gt).abs()
                                              ).mean()
    return loss


def onecycle(max_lr, total, pct=0.05, div=25.0, final_div=1e4):
    """The linear OneCycle schedule: lr of update number ``step`` (from 0)."""
    warm = max(1, int(total * pct))
    lo = max_lr / div
    end = lo / final_div

    def lr(step):
        if step < warm:
            return lo + (max_lr - lo) * step / warm
        s = min(step - warm, total - warm)
        return max_lr + (end - max_lr) * s / (total - warm)

    return lr


def steps(ref, P: Dict[str, torch.Tensor], batches: List[dict], cfg: dict,
          hp: dict, pr: Prec = Prec()):
    """hp: the traffic's iters, gamma, lr, num_steps, wdecay, epsilon,
    clip, and ``ref_rows``: the rows of a batch whose forward and backward
    run at a time, their loss and gradients weighted by their share of the
    batch and summed (the loss is a mean over every element, and the
    model has no batch statistics), so that the float32 reference fits
    beside nothing else (default: the whole batch). Returns {"loss": [..],
    "grad1": {name: clipped gradient of step 1}, "params": {name: after
    the last step}}."""
    names = sorted(P)
    params = {k: P[k].detach().clone().requires_grad_(True) for k in names}
    m = {k: torch.zeros_like(params[k]) for k in names}
    v = {k: torch.zeros_like(params[k]) for k in names}
    lr_of = onecycle(hp["lr"], hp["num_steps"] + 100)
    b1, b2, eps, wd = 0.9, 0.999, hp["epsilon"], hp["wdecay"]
    out = {"loss": []}
    for n, batch in enumerate(batches):
        b = batch["images"].shape[0]
        rows = hp.get("ref_rows") or b
        total = 0.0
        grads = [torch.zeros_like(params[k]) for k in names]
        for r in range(0, b, rows):
            part = {k: x[r:r + rows] for k, x in batch.items()}
            share = part["images"].shape[0] / b
            preds = ref.forward(params, part["images"], cfg, hp["iters"], pr,
                                test_mode=False, remat=True)
            loss = 0.0
            for i in range(part["flows"].shape[1]):
                loss = loss + sequence_loss(preds[:, :, i],
                                            part["flows"][:, i],
                                            part["valids"][:, i], hp["gamma"])
            got = torch.autograd.grad(share * loss,
                                      [params[k] for k in names],
                                      allow_unused=True)
            for acc, g in zip(grads, got):
                if g is not None:
                    acc.add_(g)
            total += share * float(loss.detach())
            del preds, loss, got
        loss = torch.tensor(total)
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads))
        scale = min(1.0, hp["clip"] / norm)
        grads = [g * scale for g in grads]
        out["loss"].append(float(loss.detach()))
        if n == 0:
            out["grad1"] = {k: g.detach() for k, g in zip(names, grads)}
        lr, t = lr_of(n), n + 1
        with torch.no_grad():
            for k, g in zip(names, grads):
                p = params[k]
                m[k].mul_(b1).add_((1 - b1) * g)
                v[k].mul_(b2).add_((1 - b2) * g * g)
                mhat = m[k] / (1 - b1 ** t)
                vhat = v[k] / (1 - b2 ** t)
                p.mul_(1 - lr * wd)
                p.sub_(lr * mhat / (vhat.sqrt() + eps))
    out["params"] = {k: params[k].detach() for k in names}
    return out
