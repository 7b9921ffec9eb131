"""Flat npz parameter files in the JAX package's layout (port of
streamflow_tpu/training/checkpoint.py:55-92): one array per flax path
("params/fnet/.../kernel"), so an npz written by either package loads in
the other. Into the port: ``params.load_jax(model,
load_variables_npz(path))``; out of it: ``save_params_npz(path,
{"params": tree})`` with the tree rebuilt from ``params.to_jax``.

The checkpoint manager (keep-N atomic saves, exact resume) comes with the
rest of training.
"""

from __future__ import annotations

import numpy as np


def save_params_npz(path: str, params) -> None:
    """Flat-file param export (portable, dependency-free restore)."""
    flat = {}

    def rec(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                rec(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(tree)

    rec("", params)
    np.savez(path, **flat)


def load_params_npz(path: str):
    """Inverse of save_params_npz: rebuild the nested dict."""
    flat = np.load(path)
    params = {}
    for key in flat.files:
        parts = key.split("/")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return params


def load_variables_npz(path: str):
    """Load an npz as a flax variables dict: a bare params tree is wrapped
    as {'params': ...}; a full variables export with top-level 'params'
    (tools/convert.py's layout) is returned as it is."""
    tree = load_params_npz(path)
    return tree if "params" in tree else {"params": tree}
