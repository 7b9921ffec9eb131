"""Weight bridge between the JAX package's StreamFlow (flax parameters) and
the port (a ``state_dict`` named after the reference's torch keys).

Both directions run off the port's own copy of the JAX package's checkpoint
table (``streamflow_tpu_torch/convert.py``): every rule maps a flax path
(decoder parameters live under the refinement scan's ``step/`` prefix) to a
torch key and a layout kind. ``from_jax`` moves flax parameters into the
port; ``to_jax`` moves port tensors (parameters or their gradients) back to
flax paths and layouts. A released reference ``.pth`` would load into the
port as it is. Nothing here imports jax or the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from streamflow_tpu_torch.convert import build_mapping, torch_shape_for


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict) or hasattr(val, "items"):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _to_torch_layout(kind: str, value: np.ndarray) -> np.ndarray:
    if kind == "conv":        # (kh, kw, I, O) -> (O, I, kh, kw)
        return np.transpose(value, (3, 2, 0, 1))
    if kind == "linear":      # (I, O) -> (O, I)
        return np.transpose(value, (1, 0))
    return value


def from_jax(flax_params, k_conv=(1, 15), pc_updater_conv=(1, 7)
             ) -> Dict[str, torch.Tensor]:
    """flax params (``{'params': ...}`` or the bare tree) -> f32 state_dict.
    Raises on a JAX leaf no rule consumes, or a leaf of the wrong shape."""
    tree = flax_params.get("params", flax_params)
    flat = _flatten(tree)
    sd, used = {}, set()
    for dst, src, kind in build_mapping(k_conv, pc_updater_conv):
        optional = kind.endswith("?")
        kind = kind.rstrip("?")
        if dst not in flat:
            if optional:
                continue
            raise KeyError(f"JAX params lack '{dst}' (for '{src}')")
        value = flat[dst]
        want = torch_shape_for(kind, value.shape)
        value = _to_torch_layout(kind, value)
        assert value.shape == tuple(want), (dst, value.shape, want)
        sd[src] = torch.from_numpy(np.ascontiguousarray(value, np.float32))
        used.add(dst)
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"{len(unused)} JAX leaves left unused, e.g. "
                       f"{unused[:5]}")
    return sd


def to_jax(tensors: Dict[str, torch.Tensor], k_conv=(1, 15),
           pc_updater_conv=(1, 7)) -> Dict[str, np.ndarray]:
    """Port tensors keyed by parameter name (a ``state_dict``, or the
    parameters' gradients) -> {flax path: f32 array in the flax layout},
    the inverse of ``from_jax``. Raises on a key no rule names."""
    out, used = {}, set()
    for dst, src, kind in build_mapping(k_conv, pc_updater_conv):
        if src not in tensors:
            if kind.endswith("?"):
                continue
            raise KeyError(f"port tensors lack '{src}' (for '{dst}')")
        value = tensors[src].detach().float().cpu().numpy()
        kind = kind.rstrip("?")
        if kind == "conv":        # (O, I, kh, kw) -> (kh, kw, I, O)
            value = np.transpose(value, (2, 3, 1, 0))
        elif kind == "linear":    # (O, I) -> (I, O)
            value = np.transpose(value, (1, 0))
        out[dst] = np.ascontiguousarray(value)
        used.add(src)
    unused = sorted(set(tensors) - used)
    if unused:
        raise KeyError(f"{len(unused)} port tensors left unmapped, e.g. "
                       f"{unused[:5]}")
    return out


def load_jax(model: torch.nn.Module, flax_params) -> None:
    """Copy JAX params into ``model`` (cast to its dtype). Raises if a port
    parameter is left unset or a shape disagrees."""
    cfg = getattr(model, "cfg", None)
    kw = {} if cfg is None else dict(k_conv=tuple(cfg.k_conv),
                                     pc_updater_conv=tuple(cfg.pc_updater_conv))
    sd = from_jax(flax_params, **kw)
    own = model.state_dict()
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
    model.load_state_dict(sd, strict=True)
