"""Port parity of the warm start (ops/warp.py), the tiled forward
(tiling.py) and the npz weight files (training/checkpoint.py) against the
JAX package, on the CPU in f32. (An npz that the JAX package writes is
loaded into the port in test_torch_serving_tools.py, beside the other
tests of its weights.)"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_serving import ITERS, T

from streamflow_tpu import tiling as jtiling
from streamflow_tpu.ops import warp as jwarp
from streamflow_tpu.training import checkpoint as jckpt
from streamflow_tpu_torch import tiling
from streamflow_tpu_torch.ops.warp import (forward_interpolate,
                                           per_pair_warm_start)
from streamflow_tpu_torch.training import checkpoint

torch.set_num_threads(4)


def test_per_pair_warm_start_matches_jax():
    rng = np.random.default_rng(0)
    lowres = (3 * rng.standard_normal((3, 8, 12, 2))).astype(np.float32)
    got = per_pair_warm_start(lowres)
    assert got.shape == (1, 3, 8, 12, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, jwarp.per_pair_warm_start(lowres),
                               atol=1e-6, rtol=0)
    far = np.full((8, 12, 2), 100.0, np.float32)   # nothing lands inside
    np.testing.assert_array_equal(forward_interpolate(far), 0.0)


@pytest.mark.parametrize("shape,patch,overlap", [
    ((432, 1242), (432, 960), 20), ((1080, 1920), (432, 960), 20),
    ((64, 96), (32, 48), 8)])
def test_grid_indices_and_weights_match_jax(shape, patch, overlap):
    assert tiling.compute_grid_indices(shape, patch, overlap) == (
        jtiling.compute_grid_indices(shape, patch, overlap))
    np.testing.assert_array_equal(tiling.gaussian_patch_weight(patch),
                                  jtiling.gaussian_patch_weight(patch))
    with pytest.raises(ValueError):
        tiling.compute_grid_indices(shape, patch, patch[0])


@pytest.mark.parametrize("patch,overlap", [((32, 48), 8), ((32, 64), 20)])
def test_tiled_forward_matches_jax(patch, overlap):
    """A stand-in forward that depends on each tile's pixels; the blends
    agree to f32 rounding (rtol 1e-6). With 64-wide tiles over 96 columns
    the grid lists a corner past the last one (44 > 32), which both
    clamp."""
    rng = np.random.default_rng(1)
    images = rng.standard_normal((1, T, 64, 96, 3)).astype(np.float32)

    def stand_in(x, xp):
        flow = xp.stack([x[:, 1:, ..., 0] - x[:, :-1, ..., 1],
                         x[:, 1:, ..., 2] * x[:, :-1, ..., 0]], axis=-1)
        return flow

    got = tiling.tiled_forward(lambda t: stand_in(t, torch), torch.from_numpy(
        images), patch_size=patch, min_overlap=overlap)
    want = jtiling.tiled_forward(lambda t: stand_in(t, jnp),
                                 jnp.asarray(images), patch_size=patch,
                                 min_overlap=overlap)
    assert got.shape == (1, T - 1, 64, 96, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_tiled_forward_constant_flow_blend():
    """Every tile predicts one constant flow: the blend returns it, to f32
    rounding of the weighted sum and its division (rtol 1e-6)."""
    const = torch.tensor([1.5, -2.0])
    images = torch.zeros(1, T, 64, 96, 3)
    out = tiling.tiled_forward(
        lambda t: const.expand(t.shape[0], T - 1, 32, 48, 2), images,
        patch_size=(32, 48), min_overlap=8)
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(
        const.numpy(), out.shape), rtol=1e-6, atol=0)


def test_npz_roundtrip_and_bare_tree(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"params": {"a": {"kernel": rng.standard_normal((3, 4)).astype(
        np.float32)}, "b": rng.standard_normal(5).astype(np.float32)}}
    checkpoint.save_params_npz(str(tmp_path / "v.npz"), tree)
    back = checkpoint.load_variables_npz(str(tmp_path / "v.npz"))
    np.testing.assert_array_equal(back["params"]["a"]["kernel"],
                                  tree["params"]["a"]["kernel"])
    np.testing.assert_array_equal(back["params"]["b"], tree["params"]["b"])
    # a bare params tree is wrapped, as JAX's load_variables_npz does
    checkpoint.save_params_npz(str(tmp_path / "p.npz"), tree["params"])
    bare = checkpoint.load_variables_npz(str(tmp_path / "p.npz"))
    assert set(bare) == {"params"}
    np.testing.assert_array_equal(bare["params"]["b"], tree["params"]["b"])
    jback = jckpt.load_variables_npz(str(tmp_path / "v.npz"))
    np.testing.assert_array_equal(jback["params"]["a"]["kernel"],
                                  back["params"]["a"]["kernel"])


def test_port_weights_roundtrip_through_npz(tmp_path):
    """Port weights -> params.to_jax -> save_params_npz -> load -> load_jax:
    every tensor comes back exactly."""
    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.params import load_jax, to_jax
    from streamflow_tpu_torch.tools.common import init_weights

    tm = create_model("streamflow", cfg=StreamFlowConfig(
        T=T, iters=ITERS, mixed_precision=False), device="cpu")
    init_weights(tm, 0)
    tree = {}
    for path, value in to_jax(tm.state_dict()).items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    checkpoint.save_params_npz(str(tmp_path / "w.npz"), {"params": tree})
    other = copy.deepcopy(tm)
    for p in other.parameters():
        p.data.zero_()
    load_jax(other, checkpoint.load_variables_npz(str(tmp_path / "w.npz")))
    for (name, a), (_, b) in zip(tm.state_dict().items(),
                                 other.state_dict().items()):
        assert torch.equal(a, b), name
