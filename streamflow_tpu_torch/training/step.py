"""The training step (port of streamflow_tpu/training/step.py::
make_train_step; reference train_mf.py:224-257): per-frame-pair sequence
loss summed over the pairs, backward, the global gradient norm, clipping
to the state's ``clip``, AdamW under the OneCycle schedule.

``kitti_last_pair_only`` (the kitti stage): only the final frame pair is
supervised, the one that carries KITTI's ground truth (train_mf.py:240-241).

``bidirectional``: the batch also carries "flows_bw"/"valids_bw" (the
backward flow of each pair); the time-reversed clip is folded into the
batch axis (one forward on 2B clips, exact for the canonical model, which
has no cross-batch coupling), and its pair q is supervised by the
backward flow of original pair F-1-q.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from streamflow_tpu_torch.training.loss import sequence_loss
from streamflow_tpu_torch.training.optim import (clip_by_global_norm,
                                                 global_norm)
from streamflow_tpu_torch.training.state import TrainState


def make_loss_fn(gamma: float = 0.8, iters: int = 12,
                 kitti_last_pair_only: bool = False,
                 bidirectional: bool = False):
    """Returns loss_fn(model, batch) -> (loss, metrics): the train-mode
    forward and the per-frame-pair sequence losses, summed."""

    def supervise(preds, flows, valids):
        if kitti_last_pair_only:
            preds, flows, valids = (preds[:, :, -1:], flows[:, -1:],
                                    valids[:, -1:])
        total, metrics = 0.0, {}
        for i in range(flows.shape[1]):
            li, mi = sequence_loss(preds[:, :, i], flows[:, i], valids[:, i],
                                   gamma)
            total = total + li
            if i == 0:
                metrics = mi
        return total, metrics

    def loss_fn(model, batch):
        images = batch["images"]
        if bidirectional:
            b = images.shape[0]
            preds = model(torch.cat([images, images.flip(1)]), iters=iters,
                          test_mode=False)
            total, metrics = supervise(preds[:, :b], batch["flows"],
                                       batch["valids"])
            bt, mb = supervise(preds[:, b:], batch["flows_bw"].flip(1),
                               batch["valids_bw"].flip(1))
            return total + bt, dict(metrics, epe_bw=mb["epe"])
        preds = model(images, iters=iters, test_mode=False)
        return supervise(preds, batch["flows"], batch["valids"])

    return loss_fn


def make_train_step(gamma: float = 0.8, iters: int = 12,
                    kitti_last_pair_only: bool = False,
                    bidirectional: bool = False
                    ) -> Callable[[TrainState, Dict], Dict]:
    """Returns step(state, batch) -> metrics, updating ``state`` in place.

    batch: {"images": (B, T, H, W, 3), "flows": (B, F, H, W, 2), "valids":
    (B, F, H, W)} on the model's device. Metrics (0-d tensors): loss, epe,
    1px, 3px, 5px of the first supervised frame pair, grad_norm (before
    clipping), and epe_bw when ``bidirectional``. After the step each
    parameter's ``.grad`` holds its clipped gradient."""
    loss_fn = make_loss_fn(gamma, iters, kitti_last_pair_only, bidirectional)

    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:   # a parameter the loss misses still decays
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        clip_by_global_norm(grads, state.clip, norm)
        opt.step()
        state.scheduler.step()
        state.step += 1
        return dict(metrics, loss=loss.detach(), grad_norm=norm)

    return step
