"""K2's ``gelu`` argument: each form's plain version under ``gelu="erf"``
and ``"poly"`` against the JAX package's Pallas kernel in interpret mode
(``_ffn_pair_fwd(..., gelu=...)``) and its XLA composite
(``ffn_pair_xla(..., gelu=...)``), CPU, f32, seeded numpy inputs, the
tolerance of tests/test_ffn_kernel.py:35 (5e-5 abs/rel); the gradient
under ``"poly"`` against jax.grad of the composite (its tolerance, :83);
the tanh variant against jax.nn.gelu(approximate=True); the config's
``ffn_gelu`` rule; and ``ffn_gelu="poly"`` reaching every K2 call of a
2-iteration StreamFlow (the poly run equals an erf-configured run whose
plain K2 computes poly, and differs from the erf run)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamflow_tpu.ops.pallas import _ffn_kernel as K
from streamflow_tpu_torch.config import StreamFlowConfig, ffn_gelu_of
from streamflow_tpu_torch.ops.kernels import ffn_pair as P

torch.set_num_threads(2)
TOL = dict(atol=5e-5, rtol=5e-5)


def _w(rng, *shape, scale=None):
    scale = shape[0] ** -0.5 if scale is None else scale
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _case(form, rng):
    """(port call, JAX positional args, JAX keywords) of one form at a
    small width; x at 2x the unit scale, so that the gelus see |x| past 1
    (where poly and erf part by more than the tolerance)."""
    c, ch, co = (64, 256, 64) if form == "ln_ffn_pair" else (128, 192, 96)
    x = (2.0 * rng.standard_normal((2, 5, 24, c))).astype(np.float32)
    res = form in ("ffn_pair_k1", "ffn_pair", "ln_ffn_pair")
    co = c if res else co
    w1, b1 = _w(rng, c, ch), _w(rng, ch, scale=0.1)
    w2, b2 = _w(rng, ch, co), _w(rng, co, scale=0.1)
    t = torch.from_numpy
    pair = (t(x), t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2))
    jargs = (x, w1, b1, w2, b2)
    if form == "ffn_pair_k1":
        kw, kb = _w(rng, c, scale=0.3), _w(rng, c, scale=0.1)
        return (lambda g: P.ffn_pair_k1(*pair, t(kw), t(kb), gelu=g), jargs,
                dict(residual=True, kw=kw, kb=kb))
    if form == "ffn_pair":
        return (lambda g: P.ffn_pair(*pair, gelu=g), jargs,
                dict(residual=True))
    if form == "ln_ffn_pair":
        g_, be = 1 + _w(rng, c, scale=0.1), _w(rng, c, scale=0.1)
        return (lambda g: P.ln_ffn_pair(pair[0], t(g_), t(be), *pair[1:],
                                        gelu=g), jargs,
                dict(residual=False, add_res=True, ln=(g_, be), ln_g=g_,
                     ln_b=be))
    wp, bp = _w(rng, c, c), _w(rng, c, scale=0.1)
    if form == "pw_ffn_pair":
        return (lambda g: P.pw_ffn_pair(pair[0], t(wp.T.copy()), t(bp),
                                        *pair[1:], gelu=g), jargs,
                dict(residual=False, wp=wp, bp=bp))
    y = rng.standard_normal(x.shape).astype(np.float32)
    db = _w(rng, c, scale=0.1)
    return (lambda g: P.dwres_pw_ffn_pair(pair[0], t(y), t(db),
                                          t(wp.T.copy()), t(bp), *pair[1:],
                                          gelu=g), jargs,
            dict(residual=False, wp=wp, bp=bp, yres=y, db=db))


FORMS = ("ffn_pair_k1", "dwres_pw_ffn_pair", "ffn_pair", "pw_ffn_pair",
         "ln_ffn_pair")


@pytest.mark.parametrize("gelu", ["erf", "poly"])
@pytest.mark.parametrize("form", FORMS)
def test_form_matches_jax_kernel_and_composite(form, gelu):
    call, jargs, jkw = _case(form, np.random.default_rng(len(form)))
    got = call(gelu).numpy()
    j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
         for k, v in jkw.items()}
    if "ln" in j:
        j["ln"] = tuple(jnp.asarray(v) for v in jkw["ln"])
    ja = [jnp.asarray(a) for a in jargs]
    want_k = np.asarray(K._ffn_pair_fwd(
        *ja, block_n=256, interpret=True, gelu=gelu,
        **{k: v for k, v in j.items() if k != "ln"}))
    want_x = np.asarray(K.ffn_pair_xla(
        *ja, gelu=gelu, **{k: v for k, v in j.items()
                           if k not in ("ln_g", "ln_b")}))
    np.testing.assert_allclose(got, want_k, **TOL)
    np.testing.assert_allclose(got, want_x, **TOL)
    # the other variant is outside the tolerance: the argument is used
    other = call("erf" if gelu == "poly" else "poly").numpy()
    assert np.abs(other - want_x).max() > 5e-4


def test_poly_gradients_match_jax():
    rng = np.random.default_rng(5)
    c, ch = 64, 96
    x = (2.0 * rng.standard_normal((3, 40, c))).astype(np.float32)
    w1, b1 = _w(rng, c, ch), _w(rng, ch, scale=0.1)
    w2, b2 = _w(rng, ch, c), _w(rng, c, scale=0.1)
    g_out = rng.standard_normal((3, 40, c)).astype(np.float32)

    def loss_j(*a):
        y = K.ffn_pair_xla(*a, residual=True, gelu="poly")
        return jnp.sum(y * jnp.asarray(g_out))
    want = jax.grad(loss_j, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, w1, b1, w2, b2)))
    ts = [torch.tensor(a, requires_grad=True)
          for a in (x, w1.T.copy(), b1, w2.T.copy(), b2)]
    y = P.ffn_pair(*ts, gelu="poly")
    (y * torch.from_numpy(g_out)).sum().backward()
    for got, w, tr in zip(ts, want, (False, True, False, True, False)):
        w = np.asarray(w)
        np.testing.assert_allclose(got.grad.numpy(), w.T if tr else w,
                                   atol=5e-3, rtol=5e-3)


def test_tanh_variant_is_the_tanh_approximation():
    x = np.linspace(-8, 8, 4001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    got = P.GELUS["tanh"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    # the poly variant is JAX's _gelu_poly, op for op
    np.testing.assert_allclose(
        P.gelu_poly(torch.from_numpy(x)).numpy(),
        np.asarray(K._gelu_poly(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


def test_unknown_gelu_raises():
    x, w1, w2 = torch.randn(4, 8), torch.randn(12, 8), torch.randn(8, 12)
    with pytest.raises(ValueError):
        P.ffn_pair(x, w1, torch.zeros(12), w2, torch.zeros(8), gelu="exact")


@pytest.mark.parametrize("value,want", [("auto", "erf"), ("erf", "erf"),
                                        ("poly", "poly"), ("tanh", None),
                                        ("fast", None)])
def test_config_ffn_gelu(value, want):
    cfg = StreamFlowConfig(ffn_gelu=value)
    if want is None:
        with pytest.raises(ValueError):
            ffn_gelu_of(cfg)
    else:
        assert ffn_gelu_of(cfg) == want


def test_poly_reaches_every_k2_call_of_a_streamflow(monkeypatch):
    """Before the gelu argument the port ignored ffn_gelu: a 'poly' model
    ran erf in every K2 call. Now each of the 2 x 12 SK-block calls and
    the 8 Twins MLP calls of a 2-iteration forward computes poly."""
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.tools.common import init_weights

    imgs = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (1, 4, 64, 96, 3)).astype(np.float32))

    def forward(gelu):
        m = create_model("streamflow", device="cpu", mixed_precision=False,
                         ffn_gelu=gelu, iters=2)
        init_weights(m, 0)
        return m(imgs, test_mode=True)

    plain, seen = P.ffn_pair_plain, []

    def spy(*a, gelu="erf", **kw):
        seen.append(gelu)
        return plain(*a, gelu=gelu, **kw)
    monkeypatch.setattr(P, "ffn_pair_plain", spy)
    poly = forward("poly")
    assert seen == ["poly"] * (2 * 12 + 8)
    erf = forward("auto")
    assert seen[32:] == ["erf"] * 32

    def forced(*a, gelu="erf", **kw):
        return plain(*a, gelu="poly", **kw)
    monkeypatch.setattr(P, "ffn_pair_plain", forced)
    assert torch.equal(forward("erf"), poly)
    assert (poly - erf).abs().max() > 0
