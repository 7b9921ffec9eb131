"""Weight bridge between the JAX package's models (flax variables) and
the port (a ``state_dict`` named after the reference's torch keys): the
StreamFlow configs and the two-frame baselines (a ``RAFTConfig``).

Both directions run off the port's own copy of the JAX package's checkpoint
tables (``streamflow_tpu_torch/convert.py``): every rule maps a flax path
(decoder parameters live under the refinement scan's ``step/`` prefix) to a
torch key and a layout kind. The tables depend on the config's encoder,
``use_gma`` and kernel sizes (``convert.table_kwargs``), or, for a
RAFTConfig, its update block and GMA (``convert.build_raft_mapping``);
the default is the canonical StreamFlow. The ``params`` collection maps
to the port's parameters, the ``batch_stats`` collection (the CNN
encoders' BatchNorm running statistics) to its buffers. ``from_jax``
moves flax variables into the port; ``to_jax`` moves port tensors
(parameters or their gradients) back to flax paths and layouts, and
``to_jax_variables`` a whole ``state_dict`` with its statistics. A released reference ``.pth`` would
load into the port as it is. Nothing here imports jax or the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from streamflow_tpu_torch.config import StreamFlowConfig
from streamflow_tpu_torch.convert import (apply_rule, from_flax_layout,
                                          tables, torch_shape_for)


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict) or hasattr(val, "items"):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _tables(cfg, k_conv, pc_updater_conv):
    """(params rules, batch_stats rules) of ``cfg`` (or of the canonical
    StreamFlow with these kernel sizes)."""
    if cfg is None:
        cfg = StreamFlowConfig(k_conv=tuple(k_conv),
                               pc_updater_conv=tuple(pc_updater_conv))
    return tables(cfg)


# a flax leaf in the torch layout of its kind (tests use it too)
_to_torch_layout = from_flax_layout


def _from_flat(flat, rules, what) -> Dict[str, torch.Tensor]:
    sd, used = {}, set()
    for dst, src, kind in rules:
        optional = kind.endswith("?")
        kind = kind.rstrip("?")
        if dst not in flat:
            if optional:
                continue
            raise KeyError(f"JAX {what} lack '{dst}' (for '{src}')")
        value = flat[dst]
        want = torch_shape_for(kind, value.shape)
        value = _to_torch_layout(kind, value)
        assert value.shape == tuple(want), (dst, value.shape, want)
        sd[src] = torch.from_numpy(np.array(value, np.float32, order="C"))
        used.add(dst)
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"{len(unused)} JAX {what} leaves left unused, e.g. "
                       f"{unused[:5]}")
    return sd


def from_jax(flax_variables, k_conv=(1, 15), pc_updater_conv=(1, 7),
             cfg=None) -> Dict[str, torch.Tensor]:
    """flax variables (``{'params': ...[, 'batch_stats': ...]}``) or a bare
    params tree -> f32 state_dict (parameters, and the running statistics
    where ``batch_stats`` is given) of the config ``cfg`` (default: the
    canonical StreamFlow; a RAFTConfig for the two-frame baselines).
    Raises on a JAX leaf no rule consumes, or a leaf of the wrong
    shape."""
    rules, stats = _tables(cfg, k_conv, pc_updater_conv)
    tree = flax_variables.get("params", flax_variables)
    sd = _from_flat(_flatten(tree), rules, "params")
    if "params" in flax_variables and "batch_stats" in flax_variables:
        sd.update(_from_flat(_flatten(flax_variables["batch_stats"]), stats,
                             "batch_stats"))
    return sd


def _to_flat(tensors, rules, strict=True):
    out = {}
    for dst, src, kind in rules:
        if src not in tensors:
            if kind.endswith("?") or not strict:
                continue
            raise KeyError(f"port tensors lack '{src}' (for '{dst}')")
        value = tensors[src].detach().float().cpu().numpy()
        out[dst] = np.ascontiguousarray(apply_rule(kind, value))
    return out


def to_jax(tensors: Dict[str, torch.Tensor], k_conv=(1, 15),
           pc_updater_conv=(1, 7), cfg=None) -> Dict[str, np.ndarray]:
    """Port tensors keyed by parameter name (a ``state_dict``, or the
    parameters' gradients) -> {flax params path: f32 array in the flax
    layout}, the inverse of ``from_jax`` on the ``params`` collection; a
    ``state_dict``'s running statistics are left to
    ``to_jax_variables``. Raises on a key no rule names."""
    rules, stats = _tables(cfg, k_conv, pc_updater_conv)
    known = {src for _, src, _ in rules + stats}
    unused = sorted(set(tensors) - known)
    if unused:
        raise KeyError(f"{len(unused)} port tensors left unmapped, e.g. "
                       f"{unused[:5]}")
    return _to_flat(tensors, rules)


def to_jax_variables(state_dict: Dict[str, torch.Tensor], cfg=None
                     ) -> Dict[str, Dict[str, np.ndarray]]:
    """A port ``state_dict`` -> {'params': {flax path: array}} and, for a
    config with BatchNorm, 'batch_stats' likewise: the layout of JAX's
    variables export (training/checkpoint.py::load_variables_npz)."""
    rules, stats = _tables(cfg, (1, 15), (1, 7))
    out = {"params": to_jax(state_dict, cfg=cfg)}
    if stats:
        out["batch_stats"] = _to_flat(state_dict, stats)
    return out


def load_jax(model: torch.nn.Module, flax_variables,
             params_only: bool = False) -> None:
    """Copy JAX variables (params, and batch_stats where the model has
    BatchNorm) into ``model`` (cast to its tensors' dtypes). Raises if a
    port parameter or buffer is left unset or a shape disagrees.
    ``params_only``: only the ``params`` collection, the model's running
    statistics left as they are (JAX train_2f's ``--restore_ckpt``)."""
    cfg = getattr(model, "cfg", None)
    if params_only:
        flax_variables = {"params": flax_variables.get("params",
                                                       flax_variables)}
    sd = from_jax(flax_variables, cfg=cfg)
    own = (dict(model.named_parameters()) if params_only
           else model.state_dict())
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"bridge mismatch: port parameters unset {missing[:5]}"
                       f" ({len(missing)}), unknown keys {extra[:5]}"
                       f" ({len(extra)})")
    for key, val in sd.items():
        if tuple(own[key].shape) != tuple(val.shape):
            raise ValueError(f"{key}: port {tuple(own[key].shape)} vs JAX "
                             f"{tuple(val.shape)}")
    model.load_state_dict(sd, strict=not params_only)
