"""The training steps (port of streamflow_tpu/training/step.py::
make_train_step and make_train_step_2f; reference train_mf.py:224-257):
the sequence loss (multi-frame: per frame pair, summed over the pairs;
two-frame: of the one pair), backward, the global gradient norm, clipping
to the state's ``clip``, AdamW under the OneCycle schedule.

``kitti_last_pair_only`` (the kitti stage): only the final frame pair is
supervised, the one that carries KITTI's ground truth (train_mf.py:240-241).

``bidirectional``: the batch also carries "flows_bw"/"valids_bw" (the
backward flow of each pair), and the time-reversed clip's pair q is
supervised by the backward flow of original pair F-1-q. Without
BatchNorm the reversed clip is folded into the batch axis (one forward on
2B clips, exact: the model has no cross-batch coupling). With BatchNorm
(the CNN encoders' cnet) the step keeps two applications, so that each
direction normalises over its own B clips, and, as JAX's step
(training/step.py:66-75, 104-115), both start from the same pre-step
running statistics and the second one's update is kept: after the step
the statistics are one momentum update from the reversed clip alone (the
first direction's update is dropped).

The forward runs with ``train=True`` (JAX's ``train``): BatchNorm on batch
statistics, updating its running statistics, and remat in force.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from streamflow_tpu_torch.layers.common import BatchNorm
from streamflow_tpu_torch.training.loss import sequence_loss
from streamflow_tpu_torch.training.optim import (clip_by_global_norm,
                                                 global_norm)
from streamflow_tpu_torch.training.state import TrainState


def batch_stats(model) -> List[torch.Tensor]:
    """The model's BatchNorm running statistics (JAX's ``batch_stats``;
    empty for the Twins encoders)."""
    return [t for m in model.modules() if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var)]


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

    def apply(model, images):
        return model(images, iters=iters, test_mode=False, train=True)

    def loss_fn(model, batch):
        images = batch["images"]
        stats = batch_stats(model)
        if bidirectional and not stats:
            b = images.shape[0]
            preds = apply(model, torch.cat([images, images.flip(1)]))
            total, metrics = supervise(preds[:, :b], batch["flows"],
                                       batch["valids"])
            bt, mb = supervise(preds[:, b:], batch["flows_bw"].flip(1),
                               batch["valids_bw"].flip(1))
            return total + bt, dict(metrics, epe_bw=mb["epe"])
        before = [s.clone() for s in stats] if bidirectional else []
        total, metrics = supervise(apply(model, images), batch["flows"],
                                   batch["valids"])
        if not bidirectional:
            return total, metrics
        with torch.no_grad():     # the second application starts from
            for s, s0 in zip(stats, before):   # the pre-step statistics
                s.copy_(s0)
        bt, mb = supervise(apply(model, images.flip(1)),
                           batch["flows_bw"].flip(1),
                           batch["valids_bw"].flip(1))
        return total + bt, dict(metrics, epe_bw=mb["epe"])

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
    return _stepper(make_loss_fn(gamma, iters, kitti_last_pair_only,
                                 bidirectional))


def _stepper(loss_fn) -> Callable[[TrainState, Dict], Dict]:
    """step(state, batch): loss_fn(model, batch), backward, the global
    gradient norm, clipping, AdamW and the schedule."""

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


def make_loss_fn_2f(gamma: float = 0.8, iters: int = 12):
    """Returns loss_fn(model, batch) -> (loss, metrics) of a two-frame
    model: one train-mode application on the pair (BatchNorm's statistics
    updated once, from this batch), the sequence loss on pair 0."""

    def loss_fn(model, batch):
        images = batch["images"]
        preds = model(images[:, 0], images[:, 1], iters=iters,
                      test_mode=False, train=True)
        return sequence_loss(preds, batch["flows"][:, 0],
                             batch["valids"][:, 0], gamma)

    return loss_fn


def make_train_step_2f(gamma: float = 0.8, iters: int = 12
                       ) -> Callable[[TrainState, Dict], Dict]:
    """The two-frame (RAFT / RAFT-GMA / SKFlow) train step (port of JAX
    training/step.py::make_train_step_2f, :127-164): batch {"images": (B,
    2, H, W, 3), "flows": (B, 1, H, W, 2), "valids": (B, 1, H, W)}; the
    rest as ``make_train_step``'s step (the same metrics, clipping,
    AdamW and schedule)."""
    return _stepper(make_loss_fn_2f(gamma, iters))
