"""Train state: the model, its optimizer and schedule, and the step counter
(port of streamflow_tpu/training/state.py; reference checkpoint dict
{model, optimizer, scheduler, total_steps}, train_mf.py:207-212)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

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
               weight_decay: float = 1e-5, epsilon: float = 1e-8,
               clip: float = 1.0, pct_start: float = 0.05) -> "TrainState":
        opt, sched = make_optimizer(
            [p for p in model.parameters() if p.requires_grad], lr,
            num_steps, weight_decay, epsilon, clip, pct_start)
        return cls(model=model, optimizer=opt, scheduler=sched)

    @property
    def clip(self) -> float:
        """The largest global gradient norm the step lets through."""
        return self.optimizer.param_groups[0]["clip"]

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.optimizer.param_groups[0]["lr"]

    def state_dict(self) -> Dict[str, Any]:
        """The model's tensors, AdamW's moments and step counts, the
        scheduler's state (its ``last_epoch``) and ``step``: references to
        the live tensors, as ``nn.Module.state_dict`` gives them."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "step": self.step}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Resume from ``state_dict()``: the model's tensors copied in place,
        AdamW's moments and step counts moved to the parameters' device,
        the scheduler moved to the saved ``last_epoch``, ``step`` set.

        No ``state_dict`` holds the schedule itself (a closure), so this
        state's own schedule, built by ``create`` from this run's lr,
        num_steps and pct_start, is kept, and so are its other settings
        (clip, weight decay, eps), as JAX restores into the optax chain
        built from the CLI's arguments (tools/train.py:198-206). The next
        update's learning rate is that schedule's value at the saved step:
        the same as the saved run's when the arguments are the same."""
        self.model.load_state_dict(sd["model"])
        groups = self.optimizer.state_dict()["param_groups"]
        self.optimizer.load_state_dict({"state": sd["optimizer"]["state"],
                                        "param_groups": groups})
        epoch = sd["scheduler"]["last_epoch"]
        lrs = [base * fn(epoch) for base, fn in zip(
            self.scheduler.base_lrs, self.scheduler.lr_lambdas)]
        self.scheduler.load_state_dict(dict(
            self.scheduler.state_dict(), last_epoch=epoch,
            _step_count=sd["scheduler"]["_step_count"], _last_lr=lrs))
        for g, lr in zip(self.optimizer.param_groups, lrs):
            g["lr"] = lr
        self.step = int(sd["step"])
