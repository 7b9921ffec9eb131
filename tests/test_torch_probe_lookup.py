"""K1's work-split modes (``ops/kernels/corr_lookup_probe.py``, the port of
tools/probe_lookup.py's Pallas variants): the plain versions of ``full``,
``nofori``, ``l0_only`` and ``l123_only`` against the JAX tool's own
variants, run in interpret mode (its ``pl.pallas_call`` wrapped with
``interpret=True`` under ``jax.disable_jit()``, the output captured) on f2
prepared with ``unroll=4``, the unroll its ``build`` asks for, compared on
lanes l*128 : l*128+81 of each level (CPU, f32, 16x24, C=64; the
tolerance of tests/test_torch_corr_lookup.py, 1e-4). ``mm_only`` and
``ex_only`` are the port's own functions (JAX's are layout side effects):
``mm_only`` against a loop over the kernel's tiles, boxes and planes
written out query by query, ``ex_only`` against the plain lookup of a
constant volume (unit-vector fmaps)."""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from streamflow_tpu_torch.ops.corr import pool_pyramid
from streamflow_tpu_torch.ops.kernels import LAUNCHES
from streamflow_tpu_torch.ops.kernels import corr_lookup_probe as CP
from streamflow_tpu_torch.ops.kernels.corr_lookup import corr_lookup_plain

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
H, W, C = 16, 24, 64


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_lookup", ROOT / "tools" / "probe_lookup.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(seed=0, h=H, w=W, c=C, noise=3.0):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((1, h, w, c)).astype(np.float32)
    f2 = rng.standard_normal((1, h, w, c)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    coords = (np.stack([xs, ys], -1)[None] + noise * rng.standard_normal(
        (1, h, w, 2))).astype(np.float32)
    return f1, f2, coords


@pytest.fixture(scope="module")
def jax_variants():
    """The JAX tool's four comparable variants, each output (1, H, W,
    4*81)."""
    tool = _jax_tool()
    f1, f2, coords = _operands()
    levels = tool.FK.pool_pyramid(jnp.asarray(f2), 4)
    f1p, f2p, meta = tool.FK.prepare_inputs(jnp.asarray(f1), levels, 4, 512,
                                            unroll=4)
    orig, captured = pl.pallas_call, []

    def interpreted(*a, **kw):
        kw["interpret"] = True
        fn = orig(*a, **kw)

        def call(*args):
            out = fn(*args)
            captured.append(out)
            return out
        return call

    outs = {}
    pl.pallas_call = interpreted
    try:
        for mode in ("full", "nofori", "l0_only", "l123_only"):
            with jax.disable_jit():
                tool.build(mode, f1p, f2p, meta, jnp.asarray(coords),
                           block_q=f1p.shape[1])(jnp.float32(0.0))
            out = np.asarray(captured[-1])[:, :H * W]
            outs[mode] = out.reshape(1, H, W, 4, 128)[..., :81].reshape(
                1, H, W, 4 * 81)
    finally:
        pl.pallas_call = orig
    t = [torch.from_numpy(np.array(lv)) for lv in levels]
    return outs, (torch.from_numpy(f1), t, torch.from_numpy(coords))


@pytest.mark.parametrize("mode", ["full", "nofori", "l0_only", "l123_only"])
def test_mode_matches_the_jax_variant(jax_variants, mode):
    outs, (f1, levels, coords) = jax_variants
    want = outs[mode]
    assert np.isfinite(want).all()
    got = CP.corr_lookup_probe(f1, levels, coords, mode).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    kk = 81
    if mode == "l0_only":
        assert not got[..., kk:].any() and got[..., :kk].any()
    if mode == "l123_only":
        assert not got[..., :kk].any() and got[..., kk:].any()


def _mm_only_loops(f1, levels, coords, r=4):
    """The kernel's mm_only, written out: per level and 8x8 tile, the box
    of the window rows and columns of its queries that meet the level,
    the columns its planes cover (128, 64 or 32 at a time), and per query
    the sum of f1 . f2 over that box (f64)."""
    b, h, w, c = f1.shape
    kt, kk = 2 * r + 2, (2 * r + 1) ** 2
    out = np.zeros((b, h, w, len(levels) * kk))
    f1 = f1.astype(np.float64)
    for lvl, f2 in enumerate(levels):
        hl, wl = f2.shape[1:3]
        f2 = f2.astype(np.float64)
        inv = np.float32(1.0 / (1 << lvl))
        for bi in range(b):
            for ty in range(0, h, 8):
                for tx in range(0, w, 8):
                    qs = [(y, x) for y in range(ty, min(ty + 8, h))
                          for x in range(tx, min(tx + 8, w))]
                    box = [None, None, None, None]
                    for y, x in qs:
                        cy = min(max(np.float32(coords[bi, y, x, 1]) * inv,
                                     -(r + 3.0)), hl + r + 3.0)
                        cx = min(max(np.float32(coords[bi, y, x, 0]) * inv,
                                     -(r + 3.0)), wl + r + 3.0)
                        iy, ix = int(math.floor(cy)) - r, int(
                            math.floor(cx)) - r
                        if iy + kt > 0 and iy < hl and ix + kt > 0 \
                                and ix < wl:
                            cand = (max(iy, 0), min(iy + kt - 1, hl - 1),
                                    max(ix, 0), min(ix + kt - 1, wl - 1))
                            box = [cand[0] if box[0] is None
                                   else min(box[0], cand[0]),
                                   cand[1] if box[1] is None
                                   else max(box[1], cand[1]),
                                   cand[2] if box[2] is None
                                   else min(box[2], cand[2]),
                                   cand[3] if box[3] is None
                                   else max(box[3], cand[3])]
                    if box[0] is None:
                        continue
                    cols, x0 = [], box[2]
                    while x0 <= box[3]:
                        rest = box[3] - x0 + 1
                        nc = 128 if rest > 64 else 64 if rest > 32 else 32
                        cols += [x for x in range(x0, x0 + nc) if x < wl]
                        x0 += nc
                    region = f2[bi, box[0]:box[1] + 1][:, cols]
                    for y, x in qs:
                        out[bi, y, x, lvl * kk] = float(np.einsum(
                            "c,hwc->", f1[bi, y, x], region))
    return out


def test_mm_only_is_the_tile_box_sum():
    # far-out and off-level windows among the queries: boxes of some
    # tiles shrink or vanish at the coarse levels
    f1, f2, coords = _operands(seed=3, h=20, w=44, c=32, noise=8.0)
    coords[0, :3, :9] = [1e4, -1e4]
    coords[0, 12:, 30:] = [-30.0, 70.0]
    levels = [lv.numpy() for lv in pool_pyramid(torch.from_numpy(f2), 4)]
    got = CP.corr_lookup_probe(torch.from_numpy(f1),
                               [torch.from_numpy(lv) for lv in levels],
                               torch.from_numpy(coords), "mm_only").numpy()
    want = _mm_only_loops(f1, levels, coords)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-5)
    assert np.abs(want).max() > 1.0


def test_ex_only_is_the_lookup_of_a_constant_volume():
    """Unit-vector fmaps make f1 . f2 / sqrt(C) the constant 1/sqrt(C)."""
    _, _, coords = _operands(seed=4, noise=6.0)
    coords[0, 0, :4] = [1e4, 1e4]
    e0 = torch.zeros(1, H, W, C)
    e0[..., 0] = 1.0
    levels = pool_pyramid(e0, 4)
    tc = torch.from_numpy(coords)
    got = CP.corr_lookup_probe(torch.randn(1, H, W, C), levels, tc,
                               "ex_only")
    want = corr_lookup_plain(e0, levels, tc)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_cpu_calls_launch_nothing_and_modes_are_checked():
    f1, f2, coords = (torch.from_numpy(a) for a in _operands(seed=5))
    levels = pool_pyramid(f2, 4)
    before = dict(LAUNCHES)
    for mode in CP.MODES:
        assert CP.corr_lookup_probe(f1, levels, coords, mode).shape == (
            1, H, W, 4 * 81)
    assert LAUNCHES == before
    with pytest.raises(ValueError):
        CP.corr_lookup_probe(f1, levels, coords, "products")
