"""The system under test, reached through its own entry points only:
``models.create_model`` for the model (by the configuration's ``model``,
the port's registry name, with the ``config`` class that its
``program`` group names), the ``evaluation`` serving entry that group
names for inference (``GraphedForward``, ``GraphedForward2F``),
``training.state.TrainState`` and ``training.step.make_train_step`` for
training. Nothing else of the program is used, and nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from sfbench import inputs


def _config(cell, **extra):
    from streamflow_tpu_torch import config

    cls = getattr(config, cell.config["program"]["config"])
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in cell.config.items() if k in names}
    kw.update(extra)
    return cls(**kw)


def build(cell, seed: int, device, train: bool = False):
    """The cell's model on ``device`` with the seed's weights, as the
    program holds them (bf16 for inference, f32 parameters for
    training). Returns (model, specs, dtypes): the parameters' and
    buffers' names and shapes, and the dtype of each."""
    from streamflow_tpu_torch.models import create_model

    extra = {"iters": cell.traffic["iters"]}
    if train:
        extra["remat"] = bool(cell.traffic.get("remat", False))
    model = create_model(cell.model, cfg=_config(cell, **extra),
                         device=device, train=train)
    sd = model.state_dict()
    specs: List[Tuple[str, Tuple[int, ...]]] = [(k, tuple(v.shape))
                                                for k, v in sd.items()]
    dtypes: Dict[str, torch.dtype] = {k: v.dtype for k, v in sd.items()}
    weights = inputs.cell_weights(cell, specs, seed, device)
    with torch.no_grad():
        for k, v in sd.items():
            v.copy_(weights[k])
    return model, specs, dtypes


def graphed(cell, model):
    """The serving entry that the configuration names: a callable on one
    request's host tensor (B, T, H, W, 3), the frames passed apart where
    the entry takes them so."""
    from streamflow_tpu_torch import evaluation

    entry = cell.config["program"]
    fwd = getattr(evaluation, entry["serving"])(model, cell.traffic["iters"])
    if entry.get("frames_apart"):
        return fwd, lambda clip: fwd(*clip.unbind(1))
    return fwd, fwd


def train_state(cell, model):
    """The TrainState and the step function, as the port's trainer builds
    them (tools/train.py)."""
    from streamflow_tpu_torch.training.state import TrainState
    from streamflow_tpu_torch.training.step import make_train_step

    t = cell.traffic
    state = TrainState.create(model, t["lr"], t["num_steps"], t["wdecay"],
                              t["epsilon"], t["clip"])
    return state, make_train_step(t["gamma"], t["iters"])
