"""Port parity of the two-frame baselines' layers against the JAX modules
(streamflow_tpu/layers/update.py: FlowHead, SepConvGRU,
BasicMotionEncoder, BasicUpdateBlock, GMAUpdateBlock and
SKUpdateBlockAllDecoder with and without GMA), with the same fan-in-scaled
random weights moved through the bridge (GMA's gamma random, so the
aggregate is live). CPU, f32, seeded numpy inputs on an 8x12 grid of 3
pairs; on the CPU every kernel wrapper (K2 in the SK blocks, K3 in GMA)
runs its plain version. The GMA blocks are held against JAX's in both of
its modes: 'full' (the materialised map, JAX's RAFT default) and 'flash'
((q, k)); the port always computes the flash form.
Tolerance 1e-4 abs/rel (tests/test_torch_layers.py's): f32 in another
summation order, through the GRU's gates and the SK blocks' gelu-residual
chains."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_raft import jax_raft, port_raft
from streamflow_tpu.layers.gma import GMAAttention
from streamflow_tpu.layers.update import (BasicMotionEncoder,
                                          BasicUpdateBlock, FlowHead,
                                          GMAUpdateBlock, SepConvGRU,
                                          SKUpdateBlockAllDecoder)

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
B, HH, WW = 3, 8, 12


def _pair(update_block, use_gma):
    _, v = jax_raft(update_block, use_gma)
    return v["params"], port_raft(update_block, use_gma, v)


def _apply(module, params, *args):
    out = jax.jit(module.apply)({"params": params},
                                *jax.tree_util.tree_map(jnp.asarray, args))
    return jax.tree_util.tree_map(np.asarray, out)


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _inputs():
    """net (tanh), inp (relu), corr, flow of B pairs."""
    return (np.tanh(_rand(5, B, HH, WW, 128)),
            np.maximum(_rand(6, B, HH, WW, 128), 0),
            _rand(7, B, HH, WW, 324), _rand(8, B, HH, WW, 2, scale=3.0))


def test_flow_head():
    p, tm = _pair("raft", False)
    x = _rand(1, B, HH, WW, 128)
    want = _apply(FlowHead(256), p["step"]["update_block"]["flow_head"], x)
    got = tm.update_block.flow_head(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("update_block,width", [("raft", 256),
                                                ("gma", 384)])
def test_sep_conv_gru(update_block, width):
    """The 1x5 pass then the 5x1 pass, each with its padding; input 256
    wide in RAFT (context + motion), 384 with GMA."""
    p, tm = _pair(update_block, update_block == "gma")
    h = np.tanh(_rand(2, B, HH, WW, 128))
    x = _rand(3, B, HH, WW, width)
    want = _apply(SepConvGRU(128), p["step"]["update_block"]["gru"], h, x)
    got = tm.update_block.gru(*_t(h, x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_basic_motion_encoder():
    p, tm = _pair("raft", False)
    _, _, corr, flow = _inputs()
    want = _apply(BasicMotionEncoder(), p["step"]["update_block"]["encoder"],
                  flow, corr)
    got = tm.update_block.encoder(*_t(flow, corr))
    assert got.shape == (B, HH, WW, 128)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got[..., -2:].numpy(), flow)


def _check_block(block, p, tm, net, inp, corr, flow, attn_jax, attn_port):
    args = (net, inp, corr, flow) + ((attn_jax,) if attn_jax is not None
                                     else ())
    want = _apply(block, p["step"]["update_block"], *args)
    got = tm.update_block(*_t(net, inp, corr, flow), attn_port)
    assert len(got) == len(want) == 3
    for name, g, wv in zip(("net", "mask", "delta"), got, want):
        np.testing.assert_allclose(g.numpy(), wv, err_msg=name, **TOL)


def test_basic_update_block():
    p, tm = _pair("raft", False)
    _check_block(BasicUpdateBlock(128), p, tm, *_inputs(), None, None)


@pytest.mark.parametrize("mode", ["full", "flash"])
def test_gma_update_block(mode):
    p, tm = _pair("gma", True)
    assert abs(float(p["step"]["update_block"]["aggregator"]["gamma"][0])
               ) > 0
    net, inp, corr, flow = _inputs()
    attn = _apply(GMAAttention(1, 128, mode), p["att"], inp)
    qk = tm.att(torch.from_numpy(inp))
    _check_block(GMAUpdateBlock(128, 1, attn_mode=mode), p, tm, net, inp,
                 corr, flow, attn, qk)


@pytest.mark.parametrize("use_gma,mode", [(True, "full"), (True, "flash"),
                                          (False, None)])
def test_sk_update_block_all_decoder(use_gma, mode):
    """SKFlow's decoder; its gru takes 512 channels with GMA, 384
    without."""
    p, tm = _pair("sk", use_gma)
    c_in = tm.update_block.gru.ffn1[0].in_channels
    assert c_in == (512 if use_gma else 384)
    net, inp, corr, flow = _inputs()
    attn, qk = None, None
    if use_gma:
        attn = _apply(GMAAttention(1, 128, mode), p["att"], inp)
        qk = tm.att(torch.from_numpy(inp))
    _check_block(SKUpdateBlockAllDecoder(128, use_gma=use_gma,
                                         attn_mode=mode or "full"),
                 p, tm, net, inp, corr, flow, attn, qk)
