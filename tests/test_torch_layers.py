"""Port parity of the layers against the JAX modules, with the same
fan-in-scaled random weights moved through the bridge (GMA's gamma and the
temporal layer's zero-init weights randomised, so neither is an identity).
CPU, f32, seeded numpy inputs; on the CPU every kernel wrapper runs its
plain version. Tolerance 1e-4 abs/rel: f32 in another summation order,
through gelu-residual chains."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import streamflow_pair
from streamflow_tpu.layers.gma import GMAAggregate, GMAAttention
from streamflow_tpu.layers.sk import SKBlock
from streamflow_tpu.layers.temporal import TemporalLayer
from streamflow_tpu.layers.twins import TwinsCSC
from streamflow_tpu.layers.update import SKUpdateBlockTAMv3

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    jm, params, tm, imgs = streamflow_pair()
    return params["params"], tm, imgs


def _apply(module, params, *args):
    return np.array(jax.jit(module.apply)({"params": params},
                                            *map(jnp.asarray, args)))


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("name,c_in,out,k", [("convc1", 324, 256, (1, 15)),
                                             ("conv", 256, 126, (1, 15))])
def test_sk_block(pair, name, c_in, out, k):
    p, tm, _ = pair
    x = _rand(1, 3, 8, 12, c_in)
    want = _apply(SKBlock(out, k, dw_impl="xla"),
                  p["step"]["update_block"]["encoder"][name], x)
    got = getattr(tm.update_block.encoder, name)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mode", ["full", "flash"])
def test_gma(pair, mode):
    """The port's GMA (flash mode: (q, k), then K3's plain version per
    aggregate) against the JAX package's GMA in either of its modes."""
    p, tm, _ = pair
    inp = _rand(2, 3, 8, 12, 128)
    mf = _rand(3, 3, 8, 12, 128)
    attn = _apply(GMAAttention(1, 128, mode), p["att"], inp)
    want = _apply(GMAAggregate(1, 128, mode),
                  p["step"]["update_block"]["aggregator"], attn, mf)
    assert abs(float(p["step"]["update_block"]["aggregator"]["gamma"][0])) > 0
    got_qk = tm.att(torch.from_numpy(inp))
    if mode == "flash":
        np.testing.assert_allclose(torch.stack(got_qk).numpy(), attn,
                                   atol=2e-5)
    got = tm.update_block.aggregator(got_qk, torch.from_numpy(mf))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_temporal_layer(pair):
    p, tm, _ = pair
    x = _rand(4, 1, 3, 8, 12, 128)
    want = _apply(TemporalLayer(128),
                  p["step"]["update_block"]["transformer_block"], x)
    assert np.abs(want - x).max() > 1e-3, "the layer must not be identity"
    got = tm.update_block.transformer_block(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_update_block_step(pair):
    p, tm, _ = pair
    b, f, h, w = 1, 3, 8, 12
    net = np.tanh(_rand(5, b, f, h, w, 128))
    inp = np.maximum(_rand(6, b, f, h, w, 128), 0)
    corr = _rand(7, b, f, h, w, 324)
    flow = _rand(8, b, f, h, w, 2, scale=3.0)
    attn = _apply(GMAAttention(1, 128, "flash"), p["att"],
                  inp.reshape(b * f, h, w, 128))   # (q, k) stacked
    block = SKUpdateBlockTAMv3(128, 3, attn_mode="flash", dw_impl="xla")
    want = jax.jit(block.apply)({"params": p["step"]["update_block"]},
                                *map(jnp.asarray, (net, inp, corr, flow,
                                                   attn)))
    got = tm.update_block(*map(torch.from_numpy,
                               (net, inp, corr, flow, attn)))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), **TOL)


@pytest.mark.parametrize("gsa_flash", [False, True])
def test_twins_csc(pair, gsa_flash):
    p, tm, imgs = pair
    x = 2.0 * (imgs / 255.0) - 1.0
    want = _apply(TwinsCSC(gsa_flash=gsa_flash), p["fnet"], x)
    tm.fnet.gsa_flash = gsa_flash
    got = tm.fnet(torch.from_numpy(x))
    tm.fnet.gsa_flash = False
    assert got.shape == (1, 4, 8, 12, 256)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
