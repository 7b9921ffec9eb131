"""Train state: the model, its optimizer and schedule, and the step counter
(port of streamflow_tpu/training/state.py; reference checkpoint dict
{model, optimizer, scheduler, total_steps}, train_mf.py:207-212)."""

from __future__ import annotations

import dataclasses

import torch

from streamflow_tpu_torch.training.optim import make_optimizer


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, lr: float, num_steps: int,
               weight_decay: float = 1e-5, epsilon: float = 1e-8
               ) -> "TrainState":
        opt, sched = make_optimizer(
            [p for p in model.parameters() if p.requires_grad], lr,
            num_steps, weight_decay, epsilon)
        return cls(model=model, optimizer=opt, scheduler=sched)
