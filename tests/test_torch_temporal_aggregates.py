"""The port's temporal aggregates (``layers/gma.py``: TemporalAttentionMap,
TemporalAggregate, SpatioTemporalAggregate, SpatioTemporalAggregate2,
TMMAggregate) against the JAX package's (``layers/gma.py:99-263``), which
no model of either package builds.

CPU, f32, seeded numpy inputs: feature maps N(0, 1), attention maps the
softmax of N(0, 4) logits, every parameter random from a seed
(``_torch_parity.randomize_params``: the zero-init gammas are live, so
each branch shows) and moved by the flax path of each leaf (a 1x1 conv
kernel (1, 1, I, O) to its torch weight (O, I, 1, 1); gammas as they
are). Tolerance 1e-4 abs and rel (tests/test_torch_zoo_encoders.py's
``TOL``: f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import randomize_params
from streamflow_tpu.layers import gma as J
from streamflow_tpu_torch.layers import gma as P
from streamflow_tpu_torch.params import _flatten, _from_flat

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
B, F, H, W = 2, 3, 4, 6
N = H * W


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _attn(rng, *shape):
    """Rows of a softmax over the last axis."""
    logits = 2.0 * rng.standard_normal(shape)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _run(jmod, pmod, args, seed=1):
    """JAX's module on ``args`` with random params; the port's module with
    the same params; both outputs as numpy."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *jargs)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes["params"])
    params = randomize_params(zeros, seed)
    want = np.array(jax.jit(jmod.apply)({"params": params}, *jargs))
    flat = _flatten(params)
    rules = [(k, k.replace("/kernel", ".weight"),
              "conv" if k.endswith("/kernel") else "raw") for k in flat]
    pmod.load_state_dict(_from_flat(flat, rules, "params"))
    with torch.no_grad():
        got = pmod(*[None if a is None else torch.from_numpy(a)
                     for a in args]).numpy()
    return got, want


def test_temporal_attention_map():
    rng = np.random.default_rng(0)
    c = 8
    x = _normal(rng, B, F, H, W, c)
    got, want = _run(J.TemporalAttentionMap(), P.TemporalAttentionMap(c, F),
                     (x,))
    assert got.shape == want.shape == (B, 1, N, N)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("heads,dim_head", [(1, 16), (2, 8), (2, 12)])
def test_temporal_aggregate(heads, dim_head):
    rng = np.random.default_rng(heads * dim_head)
    c = 16
    args = (_attn(rng, B, heads, N, N), _normal(rng, B, H, W, c))
    got, want = _run(J.TemporalAggregate(heads, dim_head),
                     P.TemporalAggregate(c, heads, dim_head), args)
    assert got.shape == want.shape == (B, H, W, c)
    np.testing.assert_allclose(got, want, **TOL)


def test_temporal_map_feeds_the_aggregate():
    """TemporalAttentionMap's (B, 1, N, N) map applied by TemporalAggregate
    to one frame's features, end to end."""
    rng = np.random.default_rng(7)
    c = 16
    x = _normal(rng, B, F, H, W, c)
    _, want_map = _run(J.TemporalAttentionMap(),
                       P.TemporalAttentionMap(c, F), (x,))
    fmap = x[:, -1]
    got, want = _run(J.TemporalAggregate(1, 16), P.TemporalAggregate(c, 1, 16),
                     (want_map, fmap))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("heads,dim_head,temporal_project,temporal", [
    (1, 16, True, True), (2, 8, False, True), (2, 12, True, True),
    (1, 12, True, False)])
def test_spatio_temporal_aggregate(heads, dim_head, temporal_project,
                                   temporal):
    """The spatial aggregate with ('project', inner != C) and without its
    projection, the temporal half with and without its own projection, and
    skipped (temporal_attn=None)."""
    rng = np.random.default_rng(heads + dim_head)
    c = 16
    args = (_attn(rng, B, heads, N, N),
            _attn(rng, B, heads, N, N) if temporal else None,
            _normal(rng, B, H, W, c))
    pmod = P.SpatioTemporalAggregate(c, heads, dim_head, temporal_project)
    if not temporal:   # JAX makes no temporal parameters without the map
        pmod.temporal_project, pmod.temporal_gamma = None, None
    got, want = _run(J.SpatioTemporalAggregate(heads, dim_head,
                                               temporal_project), pmod, args)
    assert got.shape == want.shape == (B, H, W, c)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("heads,dim_head", [(1, 16), (2, 12)])
def test_spatio_temporal_aggregate2(heads, dim_head):
    """The frames side by side as one (H, F*W) grid."""
    rng = np.random.default_rng(3 * heads + dim_head)
    c = 16
    args = (_attn(rng, B, heads, F * N, F * N), _normal(rng, B * F, H, W, c))
    got, want = _run(J.SpatioTemporalAggregate2(F, heads, dim_head),
                     P.SpatioTemporalAggregate2(F, c, heads, dim_head), args)
    assert got.shape == want.shape == (B * F, H, W, c)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("heads", [1, 2])
def test_tmm_aggregate(heads):
    """Per-frame spatial aggregation, then the temporal one over the
    channel concat of the F frames."""
    rng = np.random.default_rng(11 * heads)
    c = 16
    args = (_attn(rng, B * F, heads, N, N), _attn(rng, B, heads, N, N),
            _normal(rng, B * F, H, W, c))
    got, want = _run(J.TMMAggregate(F, heads, c // heads),
                     P.TMMAggregate(F, c, heads, c // heads), args)
    assert got.shape == want.shape == (B * F, H, W, c)
    np.testing.assert_allclose(got, want, **TOL)


def test_layers_export_the_aggregates_as_jax_does():
    """The GMA modules JAX's ``layers`` package imports are the port's
    ``layers`` exports too, with the other aggregates."""
    import streamflow_tpu.layers as jl
    import streamflow_tpu_torch.layers as pl

    for name in ("GMAAttention", "GMAAggregate", "TemporalAggregate",
                 "TemporalAttentionMap"):
        assert hasattr(jl, name) and name in pl.__all__, name
    for name in pl.__all__:
        assert getattr(pl, name) is getattr(P, name)
