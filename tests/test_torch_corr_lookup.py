"""K1 (correlation lookup): the port's plain version, which the CUDA kernel
is held against on the card, vs the JAX package's Pallas kernel in
interpret mode (fused_corr_lookup) and vs its CorrPyramid.lookup. CPU, f32,
seeded numpy inputs. Tolerance 1e-4 abs/rel, as tests/test_corr_pallas.py
(f32 sums of C products in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamflow_tpu.ops import coords_grid, corr_lookup as j_corr_lookup
from streamflow_tpu.ops.pallas._fused_lookup_kernel import (
    fused_corr_lookup, pool_pyramid as j_pool_pyramid)
from streamflow_tpu_torch.ops.corr import pool_pyramid
from streamflow_tpu_torch.ops.kernels import LAUNCHES
from streamflow_tpu_torch.ops.kernels.corr_lookup import (FusedCorr,
                                                          corr_lookup,
                                                          corr_lookup_plain)

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, b, h, w, c, disp):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    coords = (np.asarray(coords_grid(b, h, w))
              + disp * rng.standard_normal((b, h, w, 2))).astype(np.float32)
    return f1, f2, coords


def _port(f1, f2, coords):
    levels = pool_pyramid(torch.from_numpy(f2), 4)
    return corr_lookup_plain(torch.from_numpy(f1), levels,
                             torch.from_numpy(coords)).numpy()


@pytest.mark.parametrize("hw,disp", [((16, 24), 0.0), ((16, 24), 3.0),
                                     ((16, 24), 50.0), ((13, 19), 6.0)])
def test_plain_lookup_matches_pallas_interpret(hw, disp):
    f1, f2, coords = _inputs(0, 2, *hw, 32, disp)
    want = np.asarray(fused_corr_lookup(
        jnp.asarray(f1), tuple(j_pool_pyramid(jnp.asarray(f2), 4)),
        jnp.asarray(coords), radius=4, block_q=128, interpret=True))
    got = _port(f1, f2, coords)
    assert got.shape == want.shape == (2, *hw, 324)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("hw,disp", [((16, 24), 8.0), ((11, 17), 30.0)])
def test_plain_lookup_matches_corr_pyramid(hw, disp):
    f1, f2, coords = _inputs(1, 1, *hw, 64, disp)
    want = np.asarray(j_corr_lookup(jnp.asarray(f1), jnp.asarray(f2),
                                    jnp.asarray(coords)))
    np.testing.assert_allclose(_port(f1, f2, coords), want, **TOL)


@pytest.mark.parametrize("xy", [(1e7, -1e7), (-9.0, 3.0), (130.0, -40.0)])
def test_out_of_range_windows_are_zero(xy):
    """Windows fully outside every level are exactly zero, including the
    coordinate clamp for huge values."""
    f1, f2, _ = _inputs(2, 1, 16, 24, 32, 0.0)
    coords = np.tile(np.asarray(xy, np.float32), (1, 16, 24, 1))
    got = _port(f1, f2, coords)
    if xy[0] > 1e6:
        np.testing.assert_array_equal(got, np.zeros_like(got))
    want = np.asarray(fused_corr_lookup(
        jnp.asarray(f1), tuple(j_pool_pyramid(jnp.asarray(f2), 4)),
        jnp.asarray(coords), radius=4, block_q=128, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    f1, f2, coords = _inputs(3, 2, 8, 16, 32, 2.0)
    f1, f2 = (torch.from_numpy(a).bfloat16() for a in (f1, f2))
    before = LAUNCHES["corr_lookup"]
    corr = FusedCorr(f1, f2, 4, 4)
    got = corr.lookup(torch.from_numpy(coords))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 8, 16, 324)
    np.testing.assert_array_equal(
        got.float().numpy(),
        corr_lookup_plain(f1, corr.levels, torch.from_numpy(coords)
                          ).float().numpy())
    assert LAUNCHES["corr_lookup"] == before
    assert corr_lookup is not corr_lookup_plain
