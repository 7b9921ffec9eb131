"""K6-K8 (the banded depthwise convs) and the 'banded' layout's composite:
the port's plain versions against the JAX package's Pallas kernels in
interpret mode (_dw_banded_mxu_fwd, _dw_banded_mxu_t_fwd,
_sk_chain_banded_fwd, as tests/test_dw_chain.py runs them), and against
the XLA composites (dw_banded_xla) where the TPU kernel refuses a width;
each wrapper's gradient against jax.vjp of the JAX custom_vjp (its
interpret forward monkeypatched in, as tests/test_dw_chain.py does); what
K5's, K6's, K7's and K8's wrappers hand their launchers (x's own storage,
an NHWC output, no copy); K7's strip plan (csrc/dw_banded_t.cu, mirrored
by t_plan); kernel_bench's K5-K8 tables and bounds. CPU,
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
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamflow_tpu.ops.pallas import _banded_dw_kernel as K
from streamflow_tpu_torch.ops.kernels import LAUNCHES
from streamflow_tpu_torch import _build
from streamflow_tpu_torch.ops.kernels import dw_banded as P
from streamflow_tpu_torch.tools import kernel_bench as KB

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
                                      ((1, 10, 12, 64), (1, 1, 5)),
                                      ((2, 7, 9, 36), (1, 1, 3)),
                                      ((1, 5, 6, 35), (9,)),
                                      ((3, 11, 13, 40), (1, 1, 15)),
                                      ((1, 55, 17, 16), (11,))])
def test_k8_plain_matches_the_pallas_kernel(shape, ks):
    """Also: no k=1 stage and two, C that is no multiple of 8 (36) or odd
    (35), H and W that fit no tile, images smaller than the halo."""
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


class _Card(torch.Tensor):
    """A CPU tensor that passes for one on the card (is_cuda), so that a
    wrapper takes its kernel path."""

    @property
    def is_cuda(self):
        return True


class _Watched(_Card):
    """A _Card that logs the torch functions called on it (or on what is
    made from it)."""
    seen = []

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        cls.seen.append(getattr(func, "__name__", str(func)))
        return super().__torch_function__(func, types, args, kwargs or {})


@pytest.mark.parametrize("kernel,ks", [
    pytest.param("k8", (15,), id="ks0"), pytest.param("k8", (1, 15), id="ks1"),
    pytest.param("k8", (1, 1, 7), id="ks2"),
    pytest.param("k6", (15,), id="k6-15"), pytest.param("k6", (7,), id="k6-7"),
    pytest.param("k7", (15,), id="k7-15"), pytest.param("k7", (7,), id="k7-7"),
    pytest.param("k5", (1, 15), id="k5-1-15"),
    pytest.param("k5", (1, 1, 7), id="k5-1-1-7")])
def test_k8_wrapper_hands_the_launcher_x_and_an_nhwc_output(monkeypatch,
                                                            kernel, ks):
    """K8's _run_chain, K6's _run_mxu, K7's _run_mxu_t and K5's _run
    (dw_chain) pass x's own storage and a fresh (B, H, W, C) output to
    their launchers (sf_sk_chain_banded, sf_dw_banded_mxu,
    sf_dw_banded_mxu_t, sf_dw_chain) and return that output: no pad,
    permute or contiguous copy of either."""
    from streamflow_tpu_torch.ops.kernels import dw_chain as K5

    launched = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: launched.append((name, args)) or 0
    monkeypatch.setattr(_build, "library", Lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 7)
    x, ws, bs = _inputs(12, (2, 5, 6, 24), ks)
    xt = _torch(x).as_subclass(_Watched)
    wt = tuple(_torch_w(w).as_subclass(_Card) for w in ws)
    bt = tuple(_torch(b).as_subclass(_Card) for b in bs)
    _Watched.seen = []
    if kernel in ("k6", "k7"):
        out = (P._run_mxu if kernel == "k6" else P._run_mxu_t)(xt, wt[0],
                                                              bt[0])
    else:
        out = (P._run_chain if kernel == "k8" else K5._run)(xt, wt, bt, ks)
    seen = set(_Watched.seen)
    assert not seen & {"pad", "permute", "contiguous", "new_zeros", "copy_",
                       "clone", "transpose", "__setitem__", "reshape",
                       "view", "to"}, seen
    ((name, args),) = launched
    assert out.shape == xt.shape and out.stride() == xt.stride()
    if kernel in ("k6", "k7"):
        assert name == {"k6": "sf_dw_banded_mxu",
                        "k7": "sf_dw_banded_mxu_t"}[kernel]
        assert args[0] == xt.data_ptr() and args[3] == out.data_ptr()
        assert args[1] == wt[0].data_ptr() and args[2] == bt[0].data_ptr()
        assert args[4:] == (2, 5, 6, 24, ks[-1], 0, 7)
        return
    assert name == {"k8": "sf_sk_chain_banded", "k5": "sf_dw_chain"}[kernel]
    assert args[0] == xt.data_ptr() and args[5] == out.data_ptr()
    assert args[6:12] == (2, 5, 6, 24, len(ks) - 1, ks[-1])
    assert args[3] == wt[-1].data_ptr() and args[4] == bt[-1].data_ptr()
    assert args[12] == 0 and args[13] == 7
    if len(ks) == 1:
        assert args[1] is None and args[2] is None


def test_kernel_bench_k8_cases_and_bound(tmp_path):
    """K8's and K5's calls in kernel_bench: the six SK blocks' dw stacks,
    12 calls each per 440x1024 clip (72) on 3x55x128 (the flow head
    1x55x128x384), 24 each per 432x960 step (144) on 3x54x120; ks (1, 15),
    the gru's (1, 7). Their bound is bytes: 0.5266 ms per clip, 0.9698 per
    step; convc1 0.0082 ms and the gru 0.0162 a call at the clip shape.
    K6's calls are the same stacks' kxk stages alone, ks (15,) and (7,):
    0.5265 ms per clip, 0.9697 per step. A checkout whose K6 or K8 wrapper
    still builds the C-major operand is told apart."""
    clip, step = KB.chain_cases(440, 1024, False), KB.chain_cases(432, 960,
                                                                  True)
    want = [(3, 324, (1, 15)), (3, 256, (1, 15)), (3, 128, (1, 15)),
            (3, 256, (1, 15)), (3, 640, (1, 7)), (1, 384, (1, 15))]
    assert [(c[0], c[3], c[4]) for c in clip] == want
    assert [(c[0], c[3], c[4]) for c in step] == want
    assert {c[1:3] + c[5:] for c in clip} == {(55, 128, 12)}
    assert {c[1:3] + c[5:] for c in step} == {(54, 120, 24)}
    assert sum(c[-1] for c in clip) == 72 and sum(c[-1] for c in step) == 144
    # x and the output, the (C, 1, 1, 1) and (C, 1, 15, 15) weights, two
    # biases, bf16
    assert KB.chain_bytes(3, 55, 128, 324, (1, 15)) == 2 * (
        2 * 3 * 55 * 128 * 324 + 324 * (1 + 225) + 2 * 324)

    def per(cases):
        return round(1e3 * sum(c[-1] * KB.chain_bytes(*c[:-1])
                               for c in cases) / KB.HBM, 4)
    assert (per(clip), per(step)) == (0.5266, 0.9698)
    assert [round(1e3 * KB.chain_bytes(*c[:-1]) / KB.HBM, 4)
            for c in (clip[0], clip[4])] == [0.0082, 0.0162]
    root = Path(__file__).resolve().parents[1]
    assert KB.nhwc_chain(root) and KB.nhwc_chain(root, "k6")
    mxu_clip = KB.chain_cases(440, 1024, False, stack=False)
    mxu_step = KB.chain_cases(432, 960, True, stack=False)
    assert [c[:4] + c[5:] for c in mxu_clip] == [c[:4] + c[5:] for c in clip]
    assert [c[:4] + c[5:] for c in mxu_step] == [c[:4] + c[5:] for c in step]
    assert [c[4] for c in mxu_clip] == [(15,)] * 4 + [(7,), (15,)]
    assert KB.chain_bytes(3, 55, 128, 324, (15,)) == 2 * (
        2 * 3 * 55 * 128 * 324 + 324 * 225 + 324)
    assert (per(mxu_clip), per(mxu_step)) == (0.5265, 0.9697)
    assert {s: KB.DW[s][0] for s in ("k5", "k6", "k8")} == {
        "k5": "dw_chain", "k6": "dw_banded_mxu", "k8": "sk_chain_banded"}
    assert set(KB.SECTIONS["k5"]) == {"dw_chain", "dw_banded"}
    assert KB.SECTIONS["k6"] == KB.SECTIONS["k8"] == ("dw_banded",)
    # the first versions' wrappers: K6's _run_mxu and K8's _run_chain
    # padded x into the C-major operand
    old = tmp_path / "streamflow_tpu_torch/ops/kernels/dw_banded.py"
    old.parent.mkdir(parents=True)
    old.write_text("    lhs, out = _operand(x, w, b)\n")
    assert not KB.nhwc_chain(tmp_path, "k6") and KB.nhwc_chain(tmp_path)
    old.write_text("    lhs, out = _operand(x, weights[-1], biases[-1])\n")
    assert KB.nhwc_chain(tmp_path, "k6") and not KB.nhwc_chain(tmp_path)


def test_kernel_bench_k7_cases_and_bound():
    """K7's section of kernel_bench: the six SK blocks' kxk stages alone,
    ks (15,) and the gru's (7,), 12 calls each per 440x1024 clip (72) on
    3x55x128 (the flow head 1x55x128x384) and 24 each per 432x960 step
    (144) on 3x54x120. Its bound is bytes: 0.5265 ms per clip, 0.9697 per
    step; convc1 0.0082 ms and the gru 0.0162 a call at the clip shape. It
    builds dw_banded.cu (K6, timed beside it, and the f32 body) and
    dw_banded_t.cu (K7)."""
    clip = KB.chain_cases(440, 1024, False, stack=False)
    step = KB.chain_cases(432, 960, True, stack=False)
    want = [(3, 324, (15,)), (3, 256, (15,)), (3, 128, (15,)),
            (3, 256, (15,)), (3, 640, (7,)), (1, 384, (15,))]
    assert [(c[0], c[3], c[4]) for c in clip] == want
    assert [(c[0], c[3], c[4]) for c in step] == want
    assert {c[1:3] + c[5:] for c in clip} == {(55, 128, 12)}
    assert {c[1:3] + c[5:] for c in step} == {(54, 120, 24)}
    assert sum(c[-1] for c in clip) == 72 and sum(c[-1] for c in step) == 144
    # x and the output, the (C, 1, 15, 15) weights and the bias, bf16
    assert KB.chain_bytes(3, 55, 128, 324, (15,)) == 2 * (
        2 * 3 * 55 * 128 * 324 + 324 * 225 + 324)

    def per(cases):
        return round(1e3 * sum(c[-1] * KB.chain_bytes(*c[:-1])
                               for c in cases) / KB.HBM, 4)
    assert (per(clip), per(step)) == (0.5265, 0.9697)
    assert [round(1e3 * KB.chain_bytes(*c[:-1]) / KB.HBM, 4)
            for c in (clip[0], clip[4])] == [0.0082, 0.0162]
    assert KB.DW["k7"] == ("dw_banded_mxu_t", "banded_mxu_t")
    assert KB.SECTIONS["k7"] == ("dw_banded", "dw_banded_t")


# K7's calls: the main path's (clip and step) and phase 3's edges
_K7_CALLS = [(3, 55, 128, c) for c in (324, 256, 128, 640)] + [
    (1, 55, 128, 384)] + [(3, 54, 120, c) for c in (324, 256, 128, 640)] + [
    (1, 54, 120, 384), (3, 55, 128, 64), (3, 55, 128, 36),
    (1, 55, 128, 35), (1, 9, 40, 34), (3, 7, 9, 40), (1, 3, 5, 16),
    (2, 1, 1, 24), (1, 55, 200, 64), (3, 54, 200, 640), (1, 130, 70, 40)]


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("nb,h,w,c", _K7_CALLS)
def test_k7_plan_covers_every_output_tile_once(nb, h, w, c, sms):
    """t_plan's strips, dealt to its grid's blocks in turn as the kernel
    deals them, cover every (image, 8 channels, 56 rows, 32 columns) tile
    of the output exactly once and the whole output; the grid is at most
    one block an SM; a strip's run of tiles fits the ring (its halo
    carried from tile to tile)."""
    t = P.T_TILES
    plan = P.t_plan(nb, h, w, c, sms)
    assert plan["grid"] == min(plan["strips"], sms) >= 1
    seen = {}
    for blk in range(plan["grid"]):
        for s in range(blk, plan["strips"], plan["grid"]):
            b, c0, ho0, t0, nt = P.t_strip(plan, s)
            assert 1 <= nt <= plan["tps"]
            for tile in range(t0, t0 + nt):
                key = (b, c0, ho0, tile)
                seen[key] = seen.get(key, 0) + 1
    want = {(b, cg * t["CB"], band * t["HB"], tile) for b in range(nb)
            for cg in range(plan["ncg"]) for band in range(plan["nbands"])
            for tile in range(plan["tiles_w"])}
    assert set(seen) == want and set(seen.values()) == {1}
    assert plan["ncg"] * t["CB"] >= c > (plan["ncg"] - 1) * t["CB"]
    assert plan["nbands"] * t["HB"] >= h > (plan["nbands"] - 1) * t["HB"]
    assert plan["tiles_w"] * t["TW"] >= w > (plan["tiles_w"] - 1) * t["TW"]


def test_k7_plan_keeps_the_halo_on_the_main_path():
    """At the clip's shapes on the H100's 132 SMs, convc1 walks four of its
    eight 16-column tiles a strip (126 strips, one wave), the gru all eight
    (120 strips), convf2 and the flow head two (96 strips each)."""
    plans = {c: P.t_plan(nb, 55, 128, c, 132)
             for nb, c in ((3, 324), (3, 128), (3, 640), (1, 384))}
    assert {c: (p["tps"], p["strips"]) for c, p in plans.items()} == {
        324: (4, 126), 128: (2, 96), 640: (8, 120), 384: (2, 96)}


def test_k7_tiles_and_shared_memory_match_the_source():
    """T_TILES and t_smem_bytes mirror csrc/dw_banded_t.cu's constants; the
    block's shared memory fits the H100's 227 KB; the box covers the band
    at k = 15, the ring a tile and its halo, and a strip's 16 channels are
    a 32-byte pixel run."""
    import re

    src = (Path(_build.__file__).resolve().parent / "csrc"
           / "dw_banded_t.cu").read_text()
    consts = {m[0]: int(m[1]) for m in
              re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert {k: consts[k] for k in P.T_TILES} == P.T_TILES
    # plan()'s cost, as t_plan weighs a strip: a tile 4, its halo step 1
    assert "(strips + sms - 1) / sms * (4 * tps + 1)" in src
    t = P.T_TILES
    assert P.t_smem_bytes() == 208272 <= P._SMEM_MAX
    assert t["HB"] + 14 <= t["LH"] and t["TW"] + 14 <= t["RING"]
    assert 14 <= t["HALO"] <= t["TW"] and t["NCW"] == t["CB"] == 16
