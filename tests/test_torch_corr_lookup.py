"""K1 (correlation lookup): the port's plain version, which the CUDA kernel
is held against on the card, vs the JAX package's Pallas kernel in
interpret mode (fused_corr_lookup) and vs its CorrPyramid.lookup. CPU, f32,
seeded numpy inputs. Tolerance 1e-4 abs/rel, as tests/test_corr_pallas.py
(f32 sums of C products in another order).

The cases include what the kernel's bf16 body branches on: smooth flow
(small per-tile boxes), H and W that are not multiples of its 8x8 tiles,
tiles that mix far-out (1e4) and in-range queries, C = 128 and 256 at
B = 3. Also kernel_bench's K1 case table and bound."""

import math

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
from streamflow_tpu_torch.tools import kernel_bench as KB

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


def _smooth_flow(rng, b, h, w, amp=8.0):
    """A 3x4 grid of N(0, amp^2) px displacements, bilinearly upsampled
    (align_corners) to (b, h, w, 2): coherent flow, as real footage."""
    coarse = amp * rng.standard_normal((b, 3, 4, 2))
    ys, xs = np.linspace(0.0, 2.0, h), np.linspace(0.0, 3.0, w)
    y0 = np.minimum(ys.astype(int), 1)
    x0 = np.minimum(xs.astype(int), 2)
    wy, wx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    top = coarse[:, y0][:, :, x0] * (1 - wx) + coarse[:, y0][:, :, x0 + 1] * wx
    bot = (coarse[:, y0 + 1][:, :, x0] * (1 - wx)
           + coarse[:, y0 + 1][:, :, x0 + 1] * wx)
    return top * (1 - wy) + bot * wy


def _inputs(seed, b, h, w, c, disp):
    """disp: the std of per-pixel Gaussian displacements, or "smooth"
    (_smooth_flow), or "mixed" (5 px jitter, with a whole 8x8 tile, half
    a tile's rows and scattered queries far out, i.e. at 1e4)."""
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    if disp == "smooth":
        flow = _smooth_flow(rng, b, h, w)
    else:
        scale = 5.0 if disp == "mixed" else disp
        flow = scale * rng.standard_normal((b, h, w, 2))
    coords = (np.asarray(coords_grid(b, h, w)) + flow).astype(np.float32)
    if disp == "mixed":
        coords[0, :4] = (1e4, 1e4)
        coords[-1, 8:16, 8:16] = (1e4, -1e4)
        coords[-1, ::3, ::5] = (-1e4, 1e4)
    return f1, f2, coords


def _port(f1, f2, coords):
    levels = pool_pyramid(torch.from_numpy(f2), 4)
    return corr_lookup_plain(torch.from_numpy(f1), levels,
                             torch.from_numpy(coords)).numpy()


@pytest.mark.parametrize("hw,disp,b,c", [
    pytest.param((16, 24), 0.0, 2, 32, id="hw0-0.0"),
    pytest.param((16, 24), 3.0, 2, 32, id="hw1-3.0"),
    pytest.param((16, 24), 50.0, 2, 32, id="hw2-50.0"),
    pytest.param((13, 19), 6.0, 2, 32, id="hw3-6.0"),
    pytest.param((16, 24), "smooth", 3, 128, id="smooth-b3-c128"),
    pytest.param((13, 19), "smooth", 3, 256, id="smooth-13x19-b3-c256"),
    pytest.param((11, 21), 3.0, 3, 256, id="ragged-11x21-b3-c256"),
    pytest.param((19, 26), "mixed", 3, 128, id="mixed-19x26-b3-c128")])
def test_plain_lookup_matches_pallas_interpret(hw, disp, b, c):
    f1, f2, coords = _inputs(0, b, *hw, c, disp)
    want = np.asarray(fused_corr_lookup(
        jnp.asarray(f1), tuple(j_pool_pyramid(jnp.asarray(f2), 4)),
        jnp.asarray(coords), radius=4, block_q=128, interpret=True))
    got = _port(f1, f2, coords)
    assert got.shape == want.shape == (b, *hw, 324)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("hw,disp", [
    pytest.param((16, 24), 8.0, id="hw0-8.0"),
    pytest.param((11, 17), 30.0, id="hw1-30.0"),
    pytest.param((13, 19), "smooth", id="smooth-13x19"),
    pytest.param((19, 26), "mixed", id="mixed-19x26")])
def test_plain_lookup_matches_corr_pyramid(hw, disp):
    f1, f2, coords = _inputs(1, 1 if isinstance(disp, float) else 3, *hw,
                             64, disp)
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


def test_kernel_bench_k1_cases_and_bound():
    """K1's calls in kernel_bench: 12 per 440x1024 clip on 3x55x128x256,
    24 per 432x960 step on 3x54x120x256, each under the three traffics;
    its bound at 440x1024 is ~38.9 MB over 3.35 TB/s, 0.0116 ms a call."""
    clip, step = KB.corr_cases(440, 1024, False), KB.corr_cases(432, 960, True)
    assert [c[0] for c in clip] == [c[0] for c in step] == [
        "smooth", "jitter30", "uniform"]
    assert {c[1:] for c in clip} == {(3, 55, 128, 256, 4, 4, 12)}
    assert {c[1:] for c in step} == {(3, 54, 120, 256, 4, 4, 24)}
    nbytes = KB.corr_bytes(3, 55, 128, 256, 4, 4)
    # f1 + pyramid (55x128, 27x64, 13x32, 6x16) + coords + 324 channels
    assert nbytes == 3 * (2 * 256 * (7040 + 9280) + 8 * 7040
                          + 2 * 7040 * 324)
    assert round(1e3 * nbytes / KB.HBM, 4) == 0.0116


@pytest.mark.parametrize("traffic", ["smooth", "jitter30", "uniform"])
def test_kernel_bench_k1_traffics(traffic):
    """Each traffic's coordinates, and its FLOP count of the taps inside
    each level against a count tap by tap."""
    gen = torch.Generator().manual_seed(0)
    b, h, w = 3, 55, 128   # the clip's K1 shape
    coords = KB.corr_coords(traffic, b, h, w, gen, "cpu")
    assert coords.shape == (b, h, w, 2) and coords.dtype == torch.float32
    flow = coords - torch.tensor(np.asarray(coords_grid(b, h, w)))
    if traffic == "smooth":   # tens of px, a few px apart at neighbours
        assert 10.0 < float(flow.abs().max()) < 200.0
        assert float((flow[:, :, 1:] - flow[:, :, :-1]).abs().max()) < 4.0
        assert float((flow[:, 1:] - flow[:, :-1]).abs().max()) < 4.0
    elif traffic == "uniform":
        assert float(coords.min()) >= 0.0
        assert (coords.amax((0, 1, 2)) <= torch.tensor([w, h])).all()
    else:   # +-30 px, with chip_smoke's far-out rows
        assert (coords[0, :4] == torch.tensor([1e4, -1e4])).all()
        assert (coords[1, :2] == torch.tensor([-20.0, 70.0])).all()
        assert float(flow[2].abs().max()) <= 30.0
    b, h, w, r = 2, 11, 21, 4
    coords = KB.corr_coords(traffic, b, h, w, gen, "cpu")
    shapes = [(h, w), (5, 10), (2, 5), (1, 2)]
    taps = 0
    for lvl, (hl, wl) in enumerate(shapes):
        for x, y in coords.reshape(-1, 2).tolist():
            x0, y0 = math.floor(x / 2 ** lvl), math.floor(y / 2 ** lvl)
            taps += (sum(0 <= x0 + d <= wl - 1 for d in range(-r, r + 2))
                     * sum(0 <= y0 + d <= hl - 1 for d in range(-r, r + 2)))
    assert KB.corr_flops(coords, shapes, 256, r) == 2 * 256 * taps
