"""Gradients of the port's kernels against the JAX package, on the CPU in f32
with seeded numpy inputs.

(a) B5, the flash-attention backward: ``flash_attention_bwd_plain`` (which
    the CUDA kernel is held against on the card) vs the Pallas kernels
    ``flash_attention_bwd_tpu`` in interpret mode (as
    tests/test_attention.py:148-170), given the same (q, k, v, dO, lse,
    delta), at a padded and an exact tile case; the plain forward's
    logsumexp vs ``flash_attention_tpu(..., return_lse=True)``. Tolerance
    2e-4 abs/rel, as tests/test_attention.py:58 (f32 sums over a few
    hundred keys in another order).
(b) The gradient of each differentiable kernel wrapper of the port (K1 the
    correlation lookup, K2's three main-path forms, K4 inside the LGA
    projections, K3 with its B5 backward) vs ``jax.vjp`` of the JAX
    package's custom_vjp wrapper of the same kernel (Pallas forwards in
    interpret mode). Tolerance: 1e-4 abs/rel of the largest gradient
    element (f32 sums of up to a few thousand terms in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from streamflow_tpu.layers.twins import _lga_fused
from streamflow_tpu.ops import coords_grid
from streamflow_tpu.ops.pallas import _attention_kernel as ak
from streamflow_tpu.ops.pallas import _ffn_kernel as JK
from streamflow_tpu.ops.pallas.attention import flash_attention as j_flash
from streamflow_tpu.ops.pallas.corr import PallasCorr
from streamflow_tpu_torch.layers.common import linear
from streamflow_tpu_torch.ops.kernels import LAUNCHES
from streamflow_tpu_torch.ops.kernels import ffn_pair as P
from streamflow_tpu_torch.ops.kernels.corr_lookup import FusedCorr
from streamflow_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_plain)
from streamflow_tpu_torch.ops.kernels.lga_attention import lga_attention

torch.set_num_threads(2)
TOL = dict(atol=2e-4, rtol=2e-4)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _grad_close(got, want, rtol=1e-4):
    """Elementwise within rtol of the element and of the largest |want|."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-6))


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("nq,nk,d", [(256, 256, 128), (200, 300, 128),
                                     (300, 140, 32)])
def test_bwd_plain_matches_pallas_interpret(nq, nk, d):
    rng = np.random.default_rng(nq + nk + d)
    q = _rand(rng, 1, 2, nq, d, scale=d ** -0.5)
    k, v = _rand(rng, 1, 2, nk, d), _rand(rng, 1, 2, nk, d)
    g = _rand(rng, 1, 2, nq, d)
    with pltpu.force_tpu_interpret_mode():
        o, lse = ak.flash_attention_tpu(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
            block_k=128, return_lse=True)
        delta = jnp.sum(jnp.asarray(g) * o, axis=-1)
        want = ak.flash_attention_bwd_tpu(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(g),
            lse, delta, block_q=128, block_k=128)
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, g, lse, delta)]
    got = flash_attention_bwd_plain(*t, q_chunk=96)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)
    # the port's forward logsumexp
    o_p, lse_p = flash_attention_plain(*t[:3], return_lse=True, kv_chunk=64,
                                       q_chunk=96)
    np.testing.assert_allclose(lse_p.numpy(), np.asarray(lse), **TOL)
    np.testing.assert_allclose(o_p.numpy(), np.asarray(o), **TOL)


def test_cpu_bwd_wrapper_is_the_plain_version():
    rng = np.random.default_rng(4)
    q, k, v, g = (torch.from_numpy(_rand(rng, 2, 1, n, 32))
                  for n in (40, 30, 30, 40))
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    delta = (g * o).sum(-1)
    before = dict(LAUNCHES)
    for a, b in zip(flash_attention_bwd(q, k, v, g, lse, delta),
                    flash_attention_bwd_plain(q, k, v, g, lse, delta)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert LAUNCHES == before


# ------------------------------------------------------------------ (b)
def _vjp(fn, args, g):
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
        return np.asarray(out), vjp(jnp.asarray(g))


def _torch_grads(fn, args, g):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad for t in ts]


def test_flash_attention_grad_matches_jax():
    rng = np.random.default_rng(11)
    q = _rand(rng, 2, 1, 96, 128, scale=128 ** -0.5)
    k, v, g = (_rand(rng, 2, 1, 80, 128), _rand(rng, 2, 1, 80, 128),
               _rand(rng, 2, 1, 96, 128))
    want_o, want = _vjp(lambda *a: j_flash(*a, scaled=True), (q, k, v), g)
    got_o, got = _torch_grads(flash_attention, (q, k, v), g)
    np.testing.assert_allclose(got_o, want_o, **TOL)
    for a, w in zip(got, want):
        _grad_close(a, w)


def test_corr_lookup_grad_matches_jax():
    """Gradients to both feature maps through the pooled pyramid and K1's
    lookup (JAX: PallasCorr's custom_vjp, XLA recompute backward)."""
    rng = np.random.default_rng(12)
    b, h, w, c = 2, 12, 16, 32
    f1, f2 = _rand(rng, b, h, w, c), _rand(rng, b, h, w, c)
    coords = (np.asarray(coords_grid(b, h, w))
              + 3.0 * rng.standard_normal((b, h, w, 2))).astype(np.float32)
    g = _rand(rng, b, h, w, 324)
    want_o, want = _vjp(lambda a, bb: PallasCorr.build(a, bb, 4, 4).lookup(
        jnp.asarray(coords)), (f1, f2), g)
    got_o, got = _torch_grads(lambda a, bb: FusedCorr(a, bb, 4, 4).lookup(
        torch.from_numpy(coords)), (f1, f2), g)
    np.testing.assert_allclose(got_o, want_o, **TOL)
    for a, w in zip(got, want):
        _grad_close(a, w)


def _t(w):  # JAX (in, out) <-> port (out, in)
    return np.ascontiguousarray(np.asarray(w).T)


@pytest.mark.parametrize("variant", ["ffn_pair_k1", "dwres_pw_ffn_pair",
                                     "ln_ffn_pair"])
def test_ffn_pair_grads_match_jax(variant):
    rng = np.random.default_rng(len(variant))
    n, c = 96, 64
    ch = 96 if variant != "ln_ffn_pair" else 256
    co = c if variant != "dwres_pw_ffn_pair" else 30
    x = _rand(rng, 2, n // 2, c)
    w1, b1 = _rand(rng, c, ch, scale=c ** -0.5), _rand(rng, ch, scale=0.1)
    w2, b2 = _rand(rng, ch, co, scale=ch ** -0.5), _rand(rng, co, scale=0.1)
    g = _rand(rng, 2, n // 2, co)
    if variant == "ffn_pair_k1":
        kw, kb = _rand(rng, co, scale=0.3), _rand(rng, co, scale=0.1)
        jargs = (x, w1, b1, w2, b2, kw, kb)
        pargs = (x, _t(w1), b1, _t(w2), b2, kw, kb)
        jfn, pfn = JK.ffn_pair_k1, P.ffn_pair_k1
        transposed = (1, 3)
    elif variant == "dwres_pw_ffn_pair":
        y, db = _rand(rng, 2, n // 2, c), _rand(rng, c, scale=0.1)
        wp, bp = _rand(rng, c, c, scale=c ** -0.5), _rand(rng, c, scale=0.1)
        jargs = (x, y, db, wp, bp, w1, b1, w2, b2)
        pargs = (x, y, db, _t(wp), bp, _t(w1), b1, _t(w2), b2)
        jfn, pfn = JK.dwres_pw_ffn_pair, P.dwres_pw_ffn_pair
        transposed = (3, 5, 7)
    else:
        ga, be = 1.0 + _rand(rng, c, scale=0.1), _rand(rng, c, scale=0.1)
        jargs = (x, ga, be, w1, b1, w2, b2)
        pargs = (x, ga, be, _t(w1), b1, _t(w2), b2)
        jfn, pfn = JK.ln_ffn_pair, P.ln_ffn_pair
        transposed = (3, 5)
    want_o, want = _vjp(jfn, jargs, g)
    got_o, got = _torch_grads(pfn, pargs, g)
    np.testing.assert_allclose(got_o, want_o, **TOL)
    for i, (a, w) in enumerate(zip(got, want)):
        _grad_close(a.T if i in transposed else a, w)


def test_lga_grads_match_jax():
    """K4 between the qkv and proj projections, as JAX's _lga_fused."""
    rng = np.random.default_rng(13)
    b, hp, wp, c, nh = 1, 14, 21, 128, 4
    x = _rand(rng, b, hp, wp, c)
    wqkv, bqkv = _rand(rng, c, 3 * c, scale=c ** -0.5), _rand(rng, 3 * c,
                                                              scale=0.1)
    wproj, bproj = _rand(rng, c, c, scale=c ** -0.5), _rand(rng, c, scale=0.1)
    g = _rand(rng, b, hp, wp, c)
    want_o, want = _vjp(lambda *a: _lga_fused(*a, 7, nh),
                        (x, wqkv, bqkv, wproj, bproj), g)

    class Lin:
        def __init__(self, w, bias):
            self.weight, self.bias = w, bias

    def port(x, wq, bq, wpj, bpj):
        qkv = linear(x, Lin(wq, bq)).contiguous()
        return linear(lga_attention(qkv, 7, nh), Lin(wpj, bpj))

    got_o, got = _torch_grads(port, (x, _t(wqkv), bqkv, _t(wproj), bproj), g)
    np.testing.assert_allclose(got_o, want_o, **TOL)
    for i, (a, w) in enumerate(zip(got, want)):
        _grad_close(a.T if i in (1, 3) else a, w)
