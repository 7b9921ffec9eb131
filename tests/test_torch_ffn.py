"""K2 (fused FFN pair): the port's plain version of each of its five forms
vs the JAX package's Pallas kernel in interpret mode (_ffn_pair_fwd, as in
tests/test_ffn_kernel.py:34) and its XLA composite ffn_pair_xla, at the SK
blocks' unaligned widths (the port takes weights in nn.Linear layout,
the transpose of JAX's). CPU, f32, seeded numpy inputs. Tolerance 5e-5
abs/rel, as tests/test_ffn_kernel.py:35."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamflow_tpu.ops.pallas import _ffn_kernel as K
from streamflow_tpu_torch.ops.kernels import ffn_pair as P

torch.set_num_threads(2)
TOL = dict(atol=5e-5, rtol=5e-5)


def _w(rng, *shape, scale=None):
    scale = shape[0] ** -0.5 if scale is None else scale
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _check(got, jax_args, jax_kw):
    """got vs the Pallas kernel (interpret mode) and vs ffn_pair_xla; the
    LayerNorm params go to the first as ln_g/ln_b, to the second as ln."""
    j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
         for k, v in jax_kw.items()}
    ja = [jnp.asarray(a) for a in jax_args]
    want_k = np.asarray(K._ffn_pair_fwd(*ja, block_n=256, interpret=True, **{
        k: v for k, v in j.items() if k != "ln"}))
    want_x = np.asarray(K.ffn_pair_xla(*ja, **{
        k: v for k, v in j.items() if k not in ("ln_g", "ln_b")}))
    np.testing.assert_allclose(got, want_k, **TOL)
    np.testing.assert_allclose(got, want_x, **TOL)


@pytest.mark.parametrize("c", [324, 128, 384])
def test_ffn_pair_k1(c):
    rng = np.random.default_rng(c)
    ch = int(1.5 * c)
    x = rng.standard_normal((2, 5, 40, c)).astype(np.float32)
    w1, b1 = _w(rng, c, ch), _w(rng, ch, scale=0.1)
    w2, b2 = _w(rng, ch, c), _w(rng, c, scale=0.1)
    kw, kb = _w(rng, c, scale=0.3), _w(rng, c, scale=0.1)
    got = P.ffn_pair_k1(*map(torch.from_numpy,
                             (x, w1.T, b1, w2.T, b2, kw, kb)))
    _check(got.numpy(), (x, w1, b1, w2, b2),
           dict(residual=True, kw=kw, kb=kb))


@pytest.mark.parametrize("c,co", [(324, 256), (640, 128), (384, 6)])
def test_dwres_pw_ffn_pair(c, co):
    rng = np.random.default_rng(c + co)
    ch = int(1.5 * c)
    x = rng.standard_normal((3, 4, 30, c)).astype(np.float32)
    y = rng.standard_normal((3, 4, 30, c)).astype(np.float32)
    db, bp = _w(rng, c, scale=0.1), _w(rng, c, scale=0.1)
    wp = _w(rng, c, c)
    w1, b1 = _w(rng, c, ch), _w(rng, ch, scale=0.1)
    w2, b2 = _w(rng, ch, co), _w(rng, co, scale=0.1)
    got = P.dwres_pw_ffn_pair(*map(torch.from_numpy,
                                   (x, y, db, wp.T, bp, w1.T, b1, w2.T, b2)))
    assert got.shape == (3, 4, 30, co)
    _check(got.numpy(), (x, w1, b1, w2, b2),
           dict(residual=False, wp=wp, bp=bp, yres=y, db=db))


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("c", [324, 640])
def test_ffn_pair(c, residual):
    rng = np.random.default_rng(c + residual)
    ch = int(1.5 * c)
    x = rng.standard_normal((3, 4, 30, c)).astype(np.float32)
    w1, b1 = _w(rng, c, ch), _w(rng, ch, scale=0.1)
    w2, b2 = _w(rng, ch, c), _w(rng, c, scale=0.1)
    got = P.ffn_pair(*map(torch.from_numpy, (x, w1.T, b1, w2.T, b2)),
                     residual=residual)
    _check(got.numpy(), (x, w1, b1, w2, b2), dict(residual=residual))


@pytest.mark.parametrize("c,co", [(324, 256), (640, 128), (384, 6)])
def test_pw_ffn_pair(c, co):
    rng = np.random.default_rng(3 * c + co)
    ch = int(1.5 * c)
    x = rng.standard_normal((3, 4, 30, c)).astype(np.float32)
    wp, bp = _w(rng, c, c), _w(rng, c, scale=0.1)
    w1, b1 = _w(rng, c, ch), _w(rng, ch, scale=0.1)
    w2, b2 = _w(rng, ch, co), _w(rng, co, scale=0.1)
    got = P.pw_ffn_pair(*map(torch.from_numpy,
                             (x, wp.T, bp, w1.T, b1, w2.T, b2)))
    assert got.shape == (3, 4, 30, co)
    _check(got.numpy(), (x, w1, b1, w2, b2),
           dict(residual=False, wp=wp, bp=bp))


@pytest.mark.parametrize("c", [128, 256])
def test_ln_ffn_pair(c):
    rng = np.random.default_rng(7 * c)
    x = (2.0 + rng.standard_normal((1, 300, c))).astype(np.float32)
    g, be = (1 + _w(rng, c, scale=0.1)), _w(rng, c, scale=0.1)
    w1, b1 = _w(rng, c, 4 * c), _w(rng, 4 * c, scale=0.1)
    w2, b2 = _w(rng, 4 * c, c), _w(rng, c, scale=0.1)
    got = P.ln_ffn_pair(*map(torch.from_numpy,
                             (x, g, be, w1.T, b1, w2.T, b2)))
    _check(got.numpy(), (x, w1, b1, w2, b2),
           dict(residual=False, add_res=True, ln=(g, be), ln_g=g, ln_b=be))


def test_cpu_wrappers_count_no_launch():
    from streamflow_tpu_torch.ops.kernels import LAUNCHES

    before = LAUNCHES["ffn_pair"]
    x = torch.randn(4, 8)
    w1, w2 = torch.randn(12, 8), torch.randn(8, 12)
    b1, b2 = torch.zeros(12), torch.zeros(8)
    P.ffn_pair_k1(x, w1, b1, w2, b2, torch.ones(8), torch.zeros(8))
    assert LAUNCHES["ffn_pair"] == before


# every K2 call of the main path (c, hidden, out, pw stage): the six SK
# blocks' two pairs in both layouts and the Twins MLPs
_MAIN_PATH = sorted({
    case for c, co in ((324, 256), (256, 192), (128, 64), (256, 126),
                       (640, 128), (384, 6))
    for case in ((c, int(1.5 * c), c, False), (c, int(1.5 * c), co, True))}
    | {(128, 512, 128, False), (256, 1024, 256, False)})


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,ch,co,pw", _MAIN_PATH)
def test_smem_plan_takes_the_main_path(c, ch, co, pw, dt):
    """The wrapper's copy of the kernel's shared-memory plan fits every
    main-path call in the 227 KB a block may use (bf16: with at least four
    weight stages)."""
    smem = P._smem_bytes(dt, c, ch, co, pw)
    assert 0 < smem <= P._SMEM_MAX
    if dt == torch.bfloat16:
        plan, stages = P._plan(c, pw)
        assert smem == plan and stages >= 4


@pytest.mark.parametrize("dt,c,ch,co,pw", [
    (torch.bfloat16, 1600, 2400, 256, False),   # x tile past 227 KB
    (torch.bfloat16, 1024, 1536, 256, True),    # x and its pw output
    (torch.bfloat16, 256, 384, 704, False),     # wider than the registers
    (torch.float32, 2048, 3072, 2048, False)])
def test_smem_plan_raises_where_a_width_cannot_fit(dt, c, ch, co, pw):
    with pytest.raises(ValueError):
        P._smem_bytes(dt, c, ch, co, pw)


def test_tma_rows_pads_only_unaligned_widths():
    w = torch.randn(486, 324)
    p = P._tma_rows(w)
    assert p.shape == (486, 328) and torch.equal(p[:, :324], w)
    assert not p[:, 324:].any()
    w8 = torch.randn(126, 384)
    assert P._tma_rows(w8) is w8
