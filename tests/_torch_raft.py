"""Shared helpers of the two-frame baselines' parity tests
(tests/test_torch_raft_*.py): the JAX RAFT / RAFT-GMA / SKFlow with
fan-in-scaled random variables (running statistics too), made from the
init's shapes with nothing compiled, and the port's model holding the
same weights through the bridge."""

from __future__ import annotations

import contextlib
import functools

import numpy as np

H, W, ITERS = 64, 96, 2
# (registry name, update_block, use_gma) of the three models and SKFlow
# without GMA
MODELS = [("raft", "raft", False), ("raft_gma", "gma", True),
          ("skflow", "sk", True), ("skflow_nogma", "sk", False)]


def images(seed=0, b=1, h=H, w=W):
    """A seeded pair of (b, h, w, 3) uint8-range f32 images."""
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 255, (b, h, w, 3)).astype(np.float32)
                 for _ in range(2))


def stats(tree, seed):
    """Running statistics: means 0.1 r, variances 0.5 + u."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if hasattr(v, "items") else (
            (0.5 + rng.random(np.shape(v))) if k == "var"
            else 0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in node.items()}
    return walk(tree)


def jax_config(update_block, use_gma, iters=ITERS):
    from streamflow_tpu.config import RAFTConfig

    return RAFTConfig(update_block=update_block, use_gma=use_gma,
                      iters=iters, mixed_precision=False)


@functools.lru_cache(maxsize=None)
def jax_raft(update_block, use_gma, seed=1):
    """The JAX RAFT of a decoder (f32, CPU) and random variables for it
    ({'params', 'batch_stats'}, f32 numpy). Made once per process;
    callers must not change them."""
    import jax
    import jax.numpy as jnp

    from _torch_parity import randomize_params
    from streamflow_tpu.models import create_model as jax_create

    jm = jax_create("raft", cfg=jax_config(update_block, use_gma))
    a, b = images()
    shapes = jax.eval_shape(
        lambda k, x, y: jm.init(k, x, y, test_mode=True),
        jax.random.PRNGKey(0), jnp.asarray(a), jnp.asarray(b))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    v = {"params": jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        randomize_params(zeros["params"], seed)),
        "batch_stats": stats(zeros["batch_stats"], seed + 1)}
    return jm, v


def port_raft(update_block, use_gma, variables, train=False, iters=ITERS):
    """The port's RAFT of that decoder (f32, CPU) holding ``variables``."""
    from streamflow_tpu_torch.config import RAFTConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.params import load_jax

    tm = create_model("raft", cfg=RAFTConfig(
        update_block=update_block, use_gma=use_gma, iters=iters,
        mixed_precision=False), device="cpu", train=train)
    load_jax(tm, variables)
    return tm


def close(got, want, iteration):
    """Flows of refinement iteration ``iteration`` (0-based): 1e-5 of the
    largest flow, times 2.7 per iteration after the first, plus 1e-4
    rtol (tests/test_torch_zoo_model.py's rule)."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=1e-4,
        atol=1e-5 * 2.7 ** iteration * max(1.0, np.abs(want).max()))


@contextlib.contextmanager
def shared_jax_forward_2f():
    """While open, the JAX package's two-frame validators share one jitted
    forward per (model, iters): each builds a JittedForward2F, which jits
    a fresh closure and so traces it again on every call. The shared
    function is the same ``model.apply(params, a, b, iters=iters,
    test_mode=True)[1]``; what each validator computes is unchanged."""
    import jax

    from streamflow_tpu import evaluation

    cache = {}

    class Shared(evaluation.JittedForward2F):
        def __call__(self, im1, im2):
            key = (id(self.model), self.iters)
            if key not in cache:
                model, iters = self.model, self.iters
                cache[key] = jax.jit(lambda p, a, b: model.apply(
                    p, a, b, iters=iters, test_mode=True)[1])
            return cache[key](self.params, im1, im2)

    saved = evaluation.JittedForward2F
    evaluation.JittedForward2F = Shared
    try:
        yield
    finally:
        evaluation.JittedForward2F = saved
