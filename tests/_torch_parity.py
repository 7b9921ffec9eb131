"""Shared helpers of the port's parity tests (tests/test_torch_*.py): seeded
numpy inputs and weights handed to both the JAX package and the port."""

from __future__ import annotations

import numpy as np


def randomize_params(tree, seed: int):
    """Fan-in-scaled random values for every leaf of a flax params tree
    (like tests/test_reference_oracle.py::_randomize), so GMA's gamma and
    the temporal layer's zero-init weights are live. LayerNorm scales are
    1 + 0.1 r; other vectors 0.05 r."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for key, val in node.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                out[key] = walk(val)
                continue
            shape = np.shape(val)
            r = rng.standard_normal(shape).astype(np.float32)
            if len(shape) >= 2:
                out[key] = r / np.sqrt(np.prod(shape[:-1]))
            elif key == "scale":
                out[key] = 1.0 + 0.1 * r
            else:
                out[key] = 0.05 * r
        return out

    return walk(tree)


def streamflow_pair(T=4, H=64, W=96, iters=2, seed=1):
    """The JAX StreamFlow (f32, CPU) with fan-in-scaled random params and
    the port's StreamFlow holding the same weights through the bridge.
    Returns (jax_model, params, port_model, images)."""
    import jax
    import jax.numpy as jnp

    from streamflow_tpu.config import StreamFlowConfig
    from streamflow_tpu.models import create_model as jax_create
    from streamflow_tpu_torch.config import StreamFlowConfig as PortConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.params import load_jax

    kw = dict(T=T, iters=iters, mixed_precision=False)
    imgs = np.random.default_rng(0).integers(
        0, 255, (1, T, H, W, 3)).astype(np.float32)
    jm = jax_create("streamflow", cfg=StreamFlowConfig(**kw))
    init = jax.jit(lambda k, x: jm.init(k, x, test_mode=True))(
        jax.random.PRNGKey(0), jnp.asarray(imgs))
    params = {"params": randomize_params(init["params"], seed)}
    tm = create_model("streamflow", cfg=PortConfig(**kw))
    load_jax(tm, params)
    return jm, params, tm, imgs
