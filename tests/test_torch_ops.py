"""Port parity of the flow primitives (streamflow_tpu_torch.ops) against the
JAX package's functions, on the CPU in f32, inputs from a seeded numpy RNG.
Tolerance 1e-5 abs/rel unless stated: the same f32 arithmetic in another
summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamflow_tpu.ops import coords as jcoords
from streamflow_tpu.ops import corr as jcorr
from streamflow_tpu.ops import padding as jpadding
from streamflow_tpu.ops import sampler as jsampler
from streamflow_tpu.ops import upsample as jupsample
from streamflow_tpu_torch.ops.coords import coords_grid
from streamflow_tpu_torch.ops.corr import CorrPyramid, pool_pyramid
from streamflow_tpu_torch.ops.padding import InputPadder
from streamflow_tpu_torch.ops.sampler import bilinear_sampler
from streamflow_tpu_torch.ops.upsample import convex_upsample

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def test_coords_grid():
    got = coords_grid(2, 5, 7).numpy()
    want = np.asarray(jcoords.coords_grid(2, 5, 7))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(429, 1017), (436, 1024)])
def test_input_padder(hw):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, *hw, 3)).astype(np.float32)
    p, jp = InputPadder(x.shape), jpadding.InputPadder(x.shape)
    assert p.padded_shape == jp.padded_shape
    got = p.pad(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp.pad(x)))
    np.testing.assert_array_equal(p.unpad(got).numpy(), x)


@pytest.mark.parametrize("scale", [1.0, 8.0])
def test_bilinear_sampler(scale):
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 9, 13, 4)).astype(np.float32)
    pts = (rng.uniform(-2, 14, (2, 5, 6, 2)) * scale / 8).astype(np.float32)
    got, gm = bilinear_sampler(torch.from_numpy(img), torch.from_numpy(pts),
                               mask=True)
    want, wm = jsampler.bilinear_sampler(jnp.asarray(img), jnp.asarray(pts),
                                         mask=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


def test_convex_upsample():
    rng = np.random.default_rng(2)
    flow = rng.standard_normal((2, 5, 7, 2)).astype(np.float32)
    mask = rng.standard_normal((2, 5, 7, 9 * 64)).astype(np.float32)
    got = convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask))
    want = jupsample.convex_upsample(jnp.asarray(flow), jnp.asarray(mask))
    assert got.shape == (2, 40, 56, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hw,disp", [((16, 24), 3.0), ((13, 19), 40.0)])
def test_corr_pyramid(hw, disp):
    """Volume (f1 . pooled f2 / sqrt(C)) and x-major window lookup, odd
    level sizes and far out-of-range windows included."""
    rng = np.random.default_rng(3)
    h, w = hw
    f1 = rng.standard_normal((2, h, w, 32)).astype(np.float32)
    f2 = rng.standard_normal((2, h, w, 32)).astype(np.float32)
    coords = (np.asarray(jcoords.coords_grid(2, h, w))
              + disp * rng.standard_normal((2, h, w, 2))).astype(np.float32)
    pyr = CorrPyramid.build(torch.from_numpy(f1), torch.from_numpy(f2))
    jpyr = jcorr.CorrPyramid.build(jnp.asarray(f1), jnp.asarray(f2))
    for lv, jlv in zip(pyr.levels, jpyr.levels):
        np.testing.assert_allclose(lv.numpy(), np.asarray(jlv), **TOL)
    got = pyr.lookup(torch.from_numpy(coords)).numpy()
    want = np.asarray(jpyr.lookup(jnp.asarray(coords)))
    assert got.shape == (2, h, w, 324)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_pool_pyramid_drops_odd_rows():
    x = np.arange(2 * 55 * 7 * 3, dtype=np.float32).reshape(2, 55, 7, 3)
    levels = pool_pyramid(torch.from_numpy(x), 4)
    assert [tuple(lv.shape[1:3]) for lv in levels] == [(55, 7), (27, 3),
                                                        (13, 1), (6, 0)]
    from streamflow_tpu.ops.pallas._fused_lookup_kernel import (
        pool_pyramid as jpool)

    for lv, jlv in zip(levels, jpool(jnp.asarray(x), 4)):
        np.testing.assert_allclose(lv.numpy(), np.asarray(jlv), **TOL)
