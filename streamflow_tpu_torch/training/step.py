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

``shard_train_step`` (JAX's, :167-177) makes the same step data-parallel
over a ``torch.distributed`` group: each rank runs it on its own rows of
the global batch, the gradients and the metrics are summed over the
group in one all-reduce, and every rank applies the same update.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from streamflow_tpu_torch.layers.common import BatchNorm, sync_batchnorm
from streamflow_tpu_torch.training.loss import masked_means, sequence_loss
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
    """Returns loss_fn(model, batch, sums=False) -> (loss, metrics): the
    train-mode forward and the per-frame-pair sequence losses, summed;
    ``sums`` as ``sequence_loss``'s."""

    def supervise(preds, flows, valids, sums):
        if kitti_last_pair_only:
            preds, flows, valids = (preds[:, :, -1:], flows[:, -1:],
                                    valids[:, -1:])
        total, metrics = 0.0, {}
        for i in range(flows.shape[1]):
            li, mi = sequence_loss(preds[:, :, i], flows[:, i], valids[:, i],
                                   gamma, sums=sums)
            total = total + li
            if i == 0:
                metrics = mi
        return total, metrics

    def apply(model, images):
        return model(images, iters=iters, test_mode=False, train=True)

    def loss_fn(model, batch, sums=False):
        images = batch["images"]
        stats = batch_stats(model)
        if bidirectional and not stats:
            b = images.shape[0]
            preds = apply(model, torch.cat([images, images.flip(1)]))
            total, metrics = supervise(preds[:, :b], batch["flows"],
                                       batch["valids"], sums)
            bt, mb = supervise(preds[:, b:], batch["flows_bw"].flip(1),
                               batch["valids_bw"].flip(1), sums)
            return total + bt, dict(metrics, epe_bw=mb["epe"])
        before = [s.clone() for s in stats] if bidirectional else []
        total, metrics = supervise(apply(model, images), batch["flows"],
                                   batch["valids"], sums)
        if not bidirectional:
            return total, metrics
        with torch.no_grad():     # the second application starts from
            for s, s0 in zip(stats, before):   # the pre-step statistics
                s.copy_(s0)
        bt, mb = supervise(apply(model, images.flip(1)),
                           batch["flows_bw"].flip(1),
                           batch["valids_bw"].flip(1), sums)
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


def _stepper(loss_fn, group=None) -> Callable[[TrainState, Dict], Dict]:
    """step(state, batch): loss_fn(model, batch), backward, the global
    gradient norm, clipping, AdamW and the schedule; with ``group``, the
    gradients, loss and metrics reduced over it first (``_all_reduce``)
    and the model's BatchNorms synced over it."""

    buf = {}     # the all-reduce's flat buffer, kept from step to step

    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        if group is not None:
            sync_batchnorm(model, group)
        opt.zero_grad(set_to_none=True)
        loss, sums = loss_fn(model, batch, sums=True)
        loss.backward()
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:   # a parameter the loss misses still decays
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        loss = loss.detach()
        if group is not None:
            loss, sums = _all_reduce(grads, loss, sums, group, buf)
        norm = global_norm(grads)
        clip_by_global_norm(grads, state.clip, norm)
        opt.step()
        state.scheduler.step()
        state.step += 1
        return dict(masked_means(sums), loss=loss, grad_norm=norm)

    step.loss_fn = loss_fn
    return step


def _all_reduce(grads, loss, sums, group, buf=None):
    """One f32 all-reduce over ``group`` of every gradient, the loss and
    the metrics' (sum, count) pairs, in one flat buffer (``buf``, a dict,
    keeps it for the next call of the same sizes). The gradients
    (in place) and the loss become their means over the ranks: with as
    many rows on every rank, the mean of the ranks' mean losses is the
    global batch's, and the mean of their gradients its gradient. The
    pairs are summed, so that ``masked_means`` divides the global sum by
    the global count, as a masked mean of the global batch does (a mean of
    the ranks' means would weigh the ranks alike whatever their
    counts). Returns (loss, sums)."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    keys = sorted(sums)
    parts = ([g.reshape(-1).float() for g in grads]
             + [loss.float().reshape(1)]
             + [torch.stack(sums[k]).float() for k in keys])
    size = sum(t.numel() for t in parts)
    buf = {} if buf is None else buf
    flat = buf.get("flat")
    if flat is None or flat.numel() != size or flat.device != loss.device:
        flat = buf["flat"] = torch.empty(size, device=loss.device)
    torch.cat(parts, out=flat)
    dist.all_reduce(flat, group=group)
    n = sum(g.numel() for g in grads)
    flat[:n + 1].div_(world)
    for g, r in zip(grads, flat[:n].split([g.numel() for g in grads])):
        g.copy_(r.view_as(g))
    pairs = flat[n + 1:].view(-1, 2)
    return flat[n].clone(), {k: (pairs[i, 0].clone(), pairs[i, 1].clone())
                             for i, k in enumerate(keys)}


def shard_train_step(step_fn, group=None) -> Callable[[TrainState, Dict],
                                                      Dict]:
    """``step_fn`` (from ``make_train_step`` or ``make_train_step_2f``)
    data-parallel over ``group`` (the default group when None; JAX's
    ``shard_train_step``, :167-177): each rank calls it with the same
    TrainState (``parallel.replicate``) and its own rows of the global
    batch, as many as every other rank. The gradients and metrics are
    reduced over the group in one all-reduce (``_all_reduce``) before the
    gradients' norm, so the norm, clipping, AdamW and the schedule run on
    the same gradients on every rank and the parameters stay equal bit
    for bit; the model's BatchNorms take their statistics over the group
    (``layers/common.py::BatchNorm``). The loss and metrics are the global
    batch's, on every rank. A group of one gives ``step_fn``'s step bit
    for bit.

    An explicit all-reduce rather than DistributedDataParallel: remat
    re-enters the forward in the backward, the bidirectional BatchNorm
    step applies the model twice before one backward, and a parameter
    the loss misses has a gradient of zeros here. Only ``all_reduce`` is
    used (and ``broadcast`` by ``replicate``), the collectives that gloo
    runs on CUDA tensors too."""
    import torch.distributed as dist

    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("shard_train_step: no process group "
                               "(parallel.initialize first)")
        group = dist.group.WORLD
    return _stepper(step_fn.loss_fn, group)


def make_loss_fn_2f(gamma: float = 0.8, iters: int = 12):
    """Returns loss_fn(model, batch, sums=False) -> (loss, metrics) of a
    two-frame model: one train-mode application on the pair (BatchNorm's
    statistics updated once, from this batch), the sequence loss on pair
    0."""

    def loss_fn(model, batch, sums=False):
        images = batch["images"]
        preds = model(images[:, 0], images[:, 1], iters=iters,
                      test_mode=False, train=True)
        return sequence_loss(preds, batch["flows"][:, 0],
                             batch["valids"][:, 0], gamma, sums=sums)

    return loss_fn


def make_train_step_2f(gamma: float = 0.8, iters: int = 12
                       ) -> Callable[[TrainState, Dict], Dict]:
    """The two-frame (RAFT / RAFT-GMA / SKFlow) train step (port of JAX
    training/step.py::make_train_step_2f, :127-164): batch {"images": (B,
    2, H, W, 3), "flows": (B, 1, H, W, 2), "valids": (B, 1, H, W)}; the
    rest as ``make_train_step``'s step (the same metrics, clipping,
    AdamW and schedule)."""
    return _stepper(make_loss_fn_2f(gamma, iters))
