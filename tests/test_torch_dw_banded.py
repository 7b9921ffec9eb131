"""K6-K8 (the banded depthwise convs) and the 'banded' layout's composite:
the port's plain versions against the JAX package's Pallas kernels in
interpret mode (_dw_banded_mxu_fwd, _dw_banded_mxu_t_fwd,
_sk_chain_banded_fwd, as tests/test_dw_chain.py runs them), and against
the XLA composites (dw_banded_xla) where the TPU kernel refuses a width;
each wrapper's gradient against jax.vjp of the JAX custom_vjp (its
interpret forward monkeypatched in, as tests/test_dw_chain.py does). CPU,
seeded numpy inputs; weights made in the JAX layout (k, k, C) and handed
to the port in PyTorch's depthwise layout (C, 1, k, k). The k=1 biases are
nonzero, so a halo of gelu(b) instead of 0 fails.

Tolerances: f32 2e-4 abs/rel, as tests/test_dw_chain.py (sums of up to
225 taps in another order); bf16 within 2 bf16 ulp of each element (K8:
+ 1e-5, for gelu's far tail, see the test), since
both sides round at the same points (K6/K7: the f32 conv once, then + b;
K8: A unrounded in the residual, rounded in the conv; the composite: the
product before the shifted add) and differ only where two f32 sums
straddle a rounding boundary; gradients 1e-4 of each leaf's largest
element (f32 sums in another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamflow_tpu.ops.pallas import _banded_dw_kernel as K
from streamflow_tpu_torch.ops.kernels import LAUNCHES
from streamflow_tpu_torch.ops.kernels import dw_banded as P

torch.set_num_threads(2)
TOL = dict(atol=2e-4, rtol=2e-4)


def _inputs(seed, shape, ks):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    ws = [(0.3 * rng.standard_normal((k, k, shape[-1]))).astype(np.float32)
          for k in ks]
    bs = [(0.5 * rng.standard_normal(shape[-1])).astype(np.float32)
          for _ in ks]
    return x, ws, bs


def _jax(a, dt=jnp.float32):
    return jnp.asarray(a, dt)


def _torch(a, dt=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt)


def _torch_w(w, dt=torch.float32):
    """(k, k, C) -> PyTorch's depthwise (C, 1, k, k)."""
    return _torch(w.transpose(2, 0, 1)[:, None], dt)


def _port_chain(x, ws, bs, ks, fn=P.sk_chain_banded_plain,
                dt=torch.float32):
    return fn(_torch(x, dt), tuple(_torch_w(w, dt) for w in ws),
              tuple(_torch(b, dt) for b in bs), ks)


def _assert_ulps(got, want, ulps=2, floor=0.0):
    """|got - want| <= ulps bf16 ulp(want) + floor, elementwise."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    e = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
    bound = ulps * np.exp2(e - 7) + floor
    err = np.abs(got - want)
    assert (err <= bound).all(), (
        f"{int((err > bound).sum())} of {err.size} elements beyond {ulps} "
        f"ulp; max err {err.max():.3e}")


@pytest.mark.parametrize("shape,k", [((3, 20, 24, 128), 15),
                                     ((1, 9, 16, 64), 7),
                                     ((2, 33, 24, 96), 15),
                                     ((2, 12, 16, 324), 15)])
def test_k6_plain_matches_the_pallas_kernel(shape, k):
    x, (w,), (b,) = _inputs(0, shape, (k,))
    want = K._dw_banded_mxu_fwd(_jax(x), _jax(w), _jax(b), interpret=True)
    got = P.dw_banded_mxu_plain(_torch(x), _torch_w(w), _torch(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape,k", [((2, 9, 12, 128), 5),
                                     ((1, 7, 10, 256), 3),
                                     ((2, 16, 11, 128), 7)])
def test_k7_plain_matches_the_pallas_kernel(shape, k):
    x, (w,), (b,) = _inputs(1, shape, (k,))
    want = K._dw_banded_mxu_t_fwd(_jax(x), _jax(w), _jax(b), interpret=True)
    got = P.dw_banded_mxu_t_plain(_torch(x), _torch_w(w), _torch(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_k7_plain_at_an_unaligned_width_matches_dw_banded_xla():
    """C=324: the TPU kernel asserts C % 128 == 0 (:220); dw_banded_xla is
    the same function in f32."""
    x, (w,), (b,) = _inputs(2, (2, 12, 16, 324), (15,))
    want = K.dw_banded_xla(_jax(x), _jax(w), _jax(b))
    got = P.dw_banded_mxu_t_plain(_torch(x), _torch_w(w), _torch(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape,ks", [((3, 20, 24, 128), (1, 15)),
                                      ((2, 12, 16, 64), (1, 7)),
                                      ((1, 9, 16, 64), (15,)),
                                      ((2, 12, 16, 324), (1, 15)),
                                      ((1, 10, 12, 64), (1, 1, 5))])
def test_k8_plain_matches_the_pallas_kernel(shape, ks):
    x, ws, bs = _inputs(3, shape, ks)
    want = K._sk_chain_banded_fwd(_jax(x), tuple(map(_jax, ws)),
                                  tuple(map(_jax, bs)), ks, interpret=True)
    np.testing.assert_allclose(_port_chain(x, ws, bs, ks).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("kernel", ["k6", "k7", "k8"])
def test_bf16_rounds_where_the_pallas_kernel_rounds(kernel):
    bf = jnp.bfloat16
    floor = 0.0
    if kernel == "k8":
        # outputs in gelu's far negative tail (|gelu| < 1e-5) differ by
        # more than 2 ulp of their own tiny size: the Pallas kernel's erf
        # is an approximation (_dw_conv_kernel._erf_f32, abs error up to
        # 1e-6) and the port's is exact; a floor of 1e-5 admits that and
        # nothing else (a residual of rounded A, or a conv of unrounded A,
        # moves hundreds of outputs by up to 6e-2)
        floor = 1e-5
        ks = (1, 7)
        x, ws, bs = _inputs(4, (2, 12, 16, 64), ks)
        want = K._sk_chain_banded_fwd(
            _jax(x, bf), tuple(_jax(w, bf) for w in ws),
            tuple(_jax(b, bf) for b in bs), ks, interpret=True)
        got = _port_chain(x, ws, bs, ks, dt=torch.bfloat16)
    else:
        # the TPU's _t kernel takes C % 128 == 0 only
        shape = (2, 12, 16, 64 if kernel == "k6" else 128)
        x, (w,), (b,) = _inputs(5, shape, (7,))
        fwd = (K._dw_banded_mxu_fwd if kernel == "k6"
               else K._dw_banded_mxu_t_fwd)
        want = fwd(_jax(x, bf), _jax(w, bf), _jax(b, bf), interpret=True)
        plain = (P.dw_banded_mxu_plain if kernel == "k6"
                 else P.dw_banded_mxu_t_plain)
        got = plain(_torch(x, torch.bfloat16), _torch_w(w, torch.bfloat16),
                    _torch(b, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _assert_ulps(got, want, floor=floor)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_banded_composite_matches_dw_banded_xla(dtype):
    x, (w,), (b,) = _inputs(6, (2, 12, 16, 64), (7,))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = K.dw_banded_xla(_jax(x, jd), _jax(w, jd), _jax(b, jd))
    got = P.dw_banded_xla(_torch(x, td), _torch_w(w, td), _torch(b, td))
    assert got.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    else:
        _assert_ulps(got, want)


def test_k8_halo_is_zero_after_the_k1_stage():
    """A one-pixel image: every tap but the centre falls in the halo, so
    out = gelu(A + A w_c + b) with A = gelu(x + x w1 + b1) (b1 != 0)."""
    x, ws, bs = _inputs(7, (1, 1, 1, 8), (1, 5))
    gelu = torch.nn.functional.gelu
    xt = _torch(x)
    a = gelu(xt + xt * _torch(ws[0][0, 0]) + _torch(bs[0]))
    want = gelu(a + a * _torch(ws[1][2, 2]) + _torch(bs[1]))
    torch.testing.assert_close(_port_chain(x, ws, bs, (1, 5)), want)


def _jax_vjp(fn, x, ws, bs, g):
    _, vjp = jax.vjp(fn, _jax(x), tuple(map(_jax, ws)), tuple(map(_jax, bs)))
    gx, gw, gb = vjp(_jax(g))
    return [np.asarray(t) for t in (gx, *gw, *gb)]


@pytest.mark.parametrize("layout", ["k6", "k7", "k8", "banded"])
def test_wrapper_gradient_matches_jax_vjp(monkeypatch, layout):
    ks = (1, 7) if layout == "k8" else (7,)
    shape = (1, 10, 16, 128 if layout == "k7" else 64)
    x, ws, bs = _inputs(8, shape, ks)
    g = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    if layout == "k8":
        monkeypatch.setattr(K, "_sk_chain_banded_fwd", functools.partial(
            K._sk_chain_banded_fwd, interpret=True))
        want = _jax_vjp(lambda x_, w_, b_: K.sk_chain_banded(x_, w_, b_, ks),
                        x, ws, bs, g)
        fn = functools.partial(P.sk_chain_banded, ks=ks)
    else:
        jfn, fn = {"k6": (K.dw_banded_mxu, P.dw_banded_mxu),
                   "k7": (K.dw_banded_mxu_t, P.dw_banded_mxu_t),
                   "banded": (K.dw_banded_xla, P.dw_banded_xla)}[layout]
        for name in ("_dw_banded_mxu_fwd", "_dw_banded_mxu_t_fwd"):
            monkeypatch.setattr(K, name, functools.partial(
                getattr(K, name), interpret=True))
        want = _jax_vjp(lambda x_, w_, b_: jfn(x_, w_[0], b_[0]), x, ws, bs,
                        g)
        fn = (lambda f: lambda x_, w_, b_: f(x_, w_[0], b_[0]))(fn)
    ins = [t.requires_grad_(True) for t in (_torch(x), *map(_torch_w, ws),
                                            *map(_torch, bs))]
    n = len(ks)
    out = fn(ins[0], tuple(ins[1:1 + n]), tuple(ins[1 + n:]))
    got = [t.numpy() for t in torch.autograd.grad(out, ins, _torch(g))]
    got[1:1 + n] = [t[:, 0].transpose(1, 2, 0) for t in got[1:1 + n]]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("layout,ks", [("banded_mxu", (1, 15)),
                                       ("banded_mxu_t", (1, 7)),
                                       ("banded_chain", (1, 15)),
                                       ("banded_chain", (15, 1, 7)),
                                       ("banded", (1, 7))])
def test_sk_block_hands_the_kernels_its_parameters(monkeypatch, layout, ks):
    """Each banded SK layout passes the kxk stages its own contiguous
    (C, 1, k, k) weights and (C,) biases, the parameters themselves with
    no copy (the launchers raise on anything else; on the CPU the plain
    versions would not notice), and runs the k=1 stages outside them
    ('banded_chain' with k_conv not (1,)*n + (k,) runs K6 per stage)."""
    from streamflow_tpu_torch.layers import sk

    seen = []

    def spy(name, fn):
        def call(x, w, b, *rest):
            seen.append((name, w, b, *rest))
            return fn(x, w, b, *rest)
        return call
    for key, fn in list(sk._STAGE_CONV.items()):
        monkeypatch.setitem(sk._STAGE_CONV, key, spy(fn.__name__, fn))
    monkeypatch.setattr(sk, "sk_chain_banded",
                        spy("sk_chain_banded", sk.sk_chain_banded))
    block = sk.SKBlock(16, 8, ks, dw_impl=layout)
    assert block(torch.randn(2, 5, 6, 16)).shape == (2, 5, 6, 8)
    convs = block.conv_list
    if layout == "banded_chain" and ks == (1, 15):
        assert [s[0] for s in seen] == ["sk_chain_banded"]
        assert all(a is m.weight for a, m in zip(seen[0][1], convs))
        assert all(a is m.bias for a, m in zip(seen[0][2], convs))
        return
    name = {"banded": "dw_banded_xla", "banded_mxu_t": "dw_banded_mxu_t"
            }.get(layout, "dw_banded_mxu")
    kxk = [m for m, k in zip(convs, ks) if k > 1]
    assert [s[0] for s in seen] == [name] * len(kxk)
    for (_, w, b), m in zip(seen, kxk):
        assert w is m.weight and b is m.bias and w.is_contiguous()


def test_cpu_wrappers_count_no_launch():
    x, ws, bs = _inputs(10, (1, 6, 8, 16), (1, 3))
    before = dict(LAUNCHES)
    xt, w1, b1 = _torch(x), _torch_w(ws[1]), _torch(bs[1])
    for fn, plain in ((P.dw_banded_mxu, P.dw_banded_mxu_plain),
                      (P.dw_banded_mxu_t, P.dw_banded_mxu_t_plain)):
        torch.testing.assert_close(fn(xt, w1, b1), plain(xt, w1, b1),
                                   rtol=0, atol=0)
    torch.testing.assert_close(
        _port_chain(x, ws, bs, (1, 3), fn=P.sk_chain_banded),
        _port_chain(x, ws, bs, (1, 3)), rtol=0, atol=0)
    assert LAUNCHES == before
