"""Optimizer: AdamW + linear OneCycle schedule + gradient clipping by global
norm (port of streamflow_tpu/training/optim.py; reference fetch_optimizer,
train_mf.py:79-85: OneCycleLR pct_start=0.05, anneal_strategy='linear',
total_steps=num_steps+100; clip 1.0 at train_mf.py:254).

``torch.optim.AdamW`` matches ``optax.adamw`` (decoupled weight decay
scaled by the learning rate, eps added after the bias-corrected square
root), and the ``LambdaLR`` below reproduces ``optax.join_schedules`` of
the two linear pieces step for step: the n-th update uses the schedule's
value at n, counting from 0.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch


def onecycle_linear(max_lr: float, total_steps: int, pct_start: float = 0.05,
                    div_factor: float = 25.0, final_div_factor: float = 1e4
                    ) -> Callable[[int], float]:
    """step -> learning rate: linear warm-up from max_lr/div_factor to
    max_lr over int(total_steps * pct_start) steps, then a linear anneal to
    max_lr/(div_factor*final_div_factor) at total_steps, flat after."""
    warm = max(1, int(total_steps * pct_start))
    init_lr = max_lr / div_factor
    final_lr = init_lr / final_div_factor

    def lr(step: int) -> float:
        if step < warm:
            frac = 1.0 - min(max(step, 0), warm) / warm
            return (init_lr - max_lr) * frac + max_lr
        s = min(step - warm, total_steps - warm)
        frac = 1.0 - s / (total_steps - warm)
        return (max_lr - final_lr) * frac + final_lr

    return lr


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   num_steps: int, weight_decay: float = 1e-5,
                   epsilon: float = 1e-8, clip: float = 1.0,
                   pct_start: float = 0.05
                   ) -> Tuple[torch.optim.AdamW,
                              torch.optim.lr_scheduler.LambdaLR]:
    """AdamW (betas 0.9, 0.999) under the OneCycle schedule over
    ``num_steps + 100`` steps, warming up over ``pct_start`` of them.
    Clipping is ``clip_by_global_norm`` to ``clip``, applied by the train
    step before ``optimizer.step()``; ``clip`` is kept in the parameter
    group, beside AdamW's own settings (``optimizer.param_groups[0]
    ["clip"]``), as optax keeps it in the chain."""
    schedule = onecycle_linear(lr, num_steps + 100, pct_start)
    opt = torch.optim.AdamW([{"params": list(params), "clip": clip}], lr=lr,
                            betas=(0.9, 0.999), eps=epsilon,
                            weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: schedule(step) / lr)
    return opt, sched


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads, max_norm: float, norm: torch.Tensor) -> None:
    """g <- g * min(1, max_norm / norm), in place, as optax (without the
    1e-6 that ``torch.nn.utils.clip_grad_norm_`` adds to the norm)."""
    scale = (max_norm / norm).clamp(max=1.0)
    torch._foreach_mul_(list(grads), scale)
