"""K5 (SK depthwise chain): the port's plain version against the JAX
package's Pallas kernel in interpret mode (_dw_chain_fwd, as
tests/test_dw_chain.py:31-38 runs it) and against its XLA composite
chain_xla at the widths the TPU kernel refuses (C % 128 != 0); the
wrapper's gradient against jax.vjp of chain_xla. CPU, f32, seeded numpy
inputs; weights made in the JAX layout (k, k, C) and handed to the port in
PyTorch's depthwise layout (C, 1, k, k). The k=1 biases
are nonzero, so a halo of gelu(b) instead of 0 fails. Tolerances: 5e-5
abs/rel for the forward (as tests/test_dw_chain.py:37-38), 1e-4 for the
gradients (f32 sums of up to 225 taps in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamflow_tpu.ops.pallas._dw_conv_kernel import _dw_chain_fwd, chain_xla
from streamflow_tpu_torch.ops.kernels import LAUNCHES
from streamflow_tpu_torch.ops.kernels.dw_chain import dw_chain, dw_chain_plain

torch.set_num_threads(2)
TOL = dict(atol=5e-5, rtol=5e-5)


def _inputs(seed, shape, ks):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    ws = [(0.3 * rng.standard_normal((k, k, shape[-1]))).astype(np.float32)
          for k in ks]
    bs = [(0.5 * rng.standard_normal(shape[-1])).astype(np.float32)
          for _ in ks]
    return x, ws, bs


def _torch_w(w):
    """(k, k, C) -> PyTorch's depthwise (C, 1, k, k)."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(2, 0, 1)
                                                 [:, None]))


def _port(x, ws, bs, ks, fn=dw_chain_plain):
    t = torch.from_numpy
    return fn(t(x), tuple(map(_torch_w, ws)), tuple(map(t, bs)), ks)


@pytest.mark.parametrize("shape,ks", [((2, 20, 24, 128), (1, 15)),
                                      ((2, 55, 40, 256), (1, 7)),
                                      ((1, 9, 16, 128), (15,)),
                                      ((1, 33, 24, 128), (1, 15))])
def test_plain_matches_the_pallas_kernel(shape, ks):
    x, ws, bs = _inputs(0, shape, ks)
    j = lambda a: tuple(map(jnp.asarray, a))  # noqa: E731
    want = _dw_chain_fwd(jnp.asarray(x), j(ws), j(bs), ks, interpret=True)
    np.testing.assert_allclose(_port(x, ws, bs, ks).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(2, 12, 20, 324), (1, 9, 16, 6)])
def test_plain_matches_chain_xla_at_unaligned_widths(shape):
    ks = (1, 15)
    x, ws, bs = _inputs(1, shape, ks)
    want = chain_xla(jnp.asarray(x), tuple(
        (jnp.asarray(w), jnp.asarray(b)) for w, b in zip(ws, bs)))
    np.testing.assert_allclose(_port(x, ws, bs, ks).numpy(),
                               np.asarray(want), **TOL)


def test_the_halo_is_zero_after_the_k1_stage():
    """A one-pixel image: every tap but the centre falls in the halo, so
    out = gelu(A + A w_c + b) with A = gelu(x (1 + w1) + b1)."""
    x, ws, bs = _inputs(2, (1, 1, 1, 8), (1, 5))
    a = torch.nn.functional.gelu(torch.from_numpy(
        x * (1 + ws[0][0, 0]) + bs[0]))
    want = torch.nn.functional.gelu(a + a * torch.from_numpy(ws[1][2, 2])
                                    + torch.from_numpy(bs[1]))
    torch.testing.assert_close(_port(x, ws, bs, (1, 5)), want)


@pytest.mark.parametrize("shape,ks", [((1, 12, 16, 128), (1, 7)),
                                      ((2, 10, 12, 324), (1, 15))])
def test_wrapper_gradient_matches_jax_vjp(shape, ks):
    x, ws, bs = _inputs(3, shape, ks)
    g = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, w_, b_: chain_xla(x_, tuple(zip(w_, b_))),
                     jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                     tuple(map(jnp.asarray, bs)))
    gx, gw, gb = vjp(jnp.asarray(g))
    ins = [t.requires_grad_(True) for t in (torch.from_numpy(x),
                                            *map(_torch_w, ws),
                                            *map(torch.from_numpy, bs))]
    n = len(ks)
    out = dw_chain(ins[0], tuple(ins[1:1 + n]), tuple(ins[1 + n:]), ks)
    got = [t.numpy() for t in torch.autograd.grad(out, ins,
                                                  torch.from_numpy(g))]
    got[1:1 + n] = [t[:, 0].transpose(1, 2, 0) for t in got[1:1 + n]]
    for a, b in zip(got, (gx, *gw, *gb)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("ks", [(1, 15), (1, 7), (15,)])
def test_sk_block_hands_dw_chain_what_the_kernel_takes(monkeypatch, ks):
    """The dw_impl='pallas' SK block passes its own contiguous (C, 1, k, k)
    weights and (C,) biases, the parameters themselves with no copy (the
    launcher raises on anything else; on the CPU the plain version would
    not notice)."""
    from streamflow_tpu_torch.layers import sk

    seen = []

    def spy(x, ws, bs, ks_):
        seen.append((ks_, [(tuple(t.shape), t.is_contiguous())
                           for t in (*ws, *bs)], (*ws, *bs)))
        return dw_chain(x, ws, bs, ks_)
    monkeypatch.setattr(sk, "dw_chain", spy)
    block = sk.SKBlock(16, 8, ks, dw_impl="pallas")
    assert block(torch.randn(2, 5, 6, 16)).shape == (2, 5, 6, 8)
    assert [s[:2] for s in seen] == [(ks, [((16, 1, k, k), True) for k in ks]
                                      + [((16,), True)] * len(ks))]
    own = [m.weight for m in block.conv_list] + [m.bias
                                                 for m in block.conv_list]
    assert all(a is b for a, b in zip(seen[0][2], own))


def test_cpu_wrapper_counts_no_launch():
    x, ws, bs = _inputs(5, (1, 6, 8, 16), (1, 3))
    before = LAUNCHES["dw_chain"]
    got = _port(x, ws, bs, (1, 3), fn=dw_chain)
    assert LAUNCHES["dw_chain"] == before
    torch.testing.assert_close(got, _port(x, ws, bs, (1, 3)), rtol=0,
                               atol=0)
