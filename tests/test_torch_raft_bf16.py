"""The port's bf16 two-frame baselines against the JAX package's bf16
RAFT, on the CPU.

Under mixed precision JAX's RAFT casts the bf16 fmaps to f32 and builds
its correlation pyramid in f32 (streamflow_tpu/models/raft.py:87, :96);
the port hands the bf16 fmaps to K1's bf16 body, with levels 1-3 averaged
in f32 and rounded once to bf16 (models/raft.py). Two checks hold the
port's path to JAX's:

- The lookup alone, bf16 fmaps with random values, 12x20 (levels down to
  1x2), C=256, coordinates up to 8 px off the grid and some far out: the
  port's bf16 lookup (``FusedCorr(pool_f32=True)``, the plain version
  here) against JAX's f32 ``CorrPyramid`` lookup rounded to bf16, as
  JAX's motion encoder rounds it. Bound, per value, from bf16 rounding
  (unit roundoff u = 2^-9): each side rounds once, u (|L| + |L'|); the
  pooled levels round once, |L - L'| <= u A, A the same lookup of |f1|
  against the pyramid of |f2| (level 0 is not rounded); f32 accumulation
  order 2e-5 A. So |port - JAX| <= 2u (|L| + A_l) + 2e-5 A, A_l = A on
  levels 1-3 and 0 on level 0. The port reads at most 0.18 of it (0.19
  with the levels averaged in bf16).
- The models at iters=1 (64x96, test mode, the upsampled flow), RAFT,
  RAFT-GMA and SKFlow with the same random variables: the port's bf16
  flow against JAX's f32 flow within 1.5x of JAX's own bf16 flow's
  relative EPE, global and per-pixel p99 (``tools/common.py::rel_epe``,
  chip_smoke's bf16 guard rule). Read: the port's bf16 path is 0.81-0.91x
  JAX's global and 0.86-0.91x its p99.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_raft import MODELS, images, jax_raft
from streamflow_tpu.config import RAFTConfig as JaxRAFTConfig
from streamflow_tpu.models import create_model as jax_create
from streamflow_tpu.ops.corr import CorrPyramid
from streamflow_tpu_torch.config import RAFTConfig
from streamflow_tpu_torch.models import create_model
from streamflow_tpu_torch.ops.kernels.corr_lookup import FusedCorr
from streamflow_tpu_torch.params import load_jax
from streamflow_tpu_torch.tools.common import rel_epe

torch.set_num_threads(2)
U = 2.0 ** -9
BF16_GUARD_RATIO = 1.5


def test_bf16_lookup_within_rounding_of_jax():
    rng = np.random.default_rng(0)
    b, h, w, c, r = 2, 12, 20, 256, 4
    f1, f2 = (torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(
        np.float32)).bfloat16() for _ in range(2))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([xs, ys], -1).astype(np.float32)
    coords = grid + rng.uniform(-8, 8, (b, h, w, 2)).astype(np.float32)
    coords[:, 0, :3] = [-40.0, 100.0]
    coords_t = torch.from_numpy(coords)

    want = np.array(CorrPyramid.build(
        jnp.asarray(f1.float().numpy()), jnp.asarray(f2.float().numpy()),
        4, r).lookup(jnp.asarray(coords)))
    got = FusedCorr(f1, f2, 4, r, pool_f32=True).lookup(coords_t)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    a = FusedCorr(f1.float().abs(), f2.float().abs(), 4, r).lookup(
        coords_t).numpy()
    a_l = a.copy()
    a_l[..., :(2 * r + 1) ** 2] = 0.0
    err = np.abs(got.float().numpy()
                 - torch.from_numpy(want).bfloat16().float().numpy())
    bound = 2 * U * (np.abs(want) + a_l) + 2e-5 * a
    assert np.isfinite(err).all()
    assert (err <= bound).all(), float((err / bound).max())
    # level 0 is the bf16 x bf16 product both ways: within one rounding
    # of each side
    lv0 = slice(0, (2 * r + 1) ** 2)
    assert (err[..., lv0] <= 2 * U * np.abs(want[..., lv0])
            + 2e-5 * a[..., lv0]).all()


@pytest.mark.parametrize("model", [m for m in MODELS if m[0] != "skflow_nogma"],
                         ids=lambda m: m[0])
def test_bf16_model_within_guard_of_jax(model):
    name, ub, gma = model
    jm, v = jax_raft(ub, gma)
    a, b = images()

    def jax_flow(mixed_precision):
        m = jax_create("raft", cfg=JaxRAFTConfig(
            update_block=ub, use_gma=gma, iters=1,
            mixed_precision=mixed_precision))
        return torch.from_numpy(np.array(jax.jit(
            lambda v, x, y: m.apply(v, x, y, test_mode=True)[1])(
            v, jnp.asarray(a), jnp.asarray(b)), np.float32))

    ref, jax_bf16 = jax_flow(False), jax_flow(True)
    tm = create_model(name, cfg=RAFTConfig(
        update_block=ub, use_gma=gma, iters=1, mixed_precision=True),
        device="cpu")
    load_jax(tm, v)
    got = tm(torch.from_numpy(a), torch.from_numpy(b), test_mode=True)[1]
    assert got.dtype == torch.float32 and got.shape == ref.shape
    port, plain = rel_epe(got, ref), rel_epe(jax_bf16, ref)
    assert all(np.isfinite(port)), port
    assert all(p <= BF16_GUARD_RATIO * j for p, j in zip(port, plain)), (
        port, plain)
