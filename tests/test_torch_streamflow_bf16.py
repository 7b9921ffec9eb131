"""The port's bf16 StreamFlow against the JAX package's, on the CPU.

Every other StreamFlow parity test runs in f32; this one holds the bf16
path: the canonical config and the ablation configs (encoders 'twins',
'twins_1dconv', 'twins_temporal_attention', 'twins_3dconv', 'basic',
'res18_3d'; on Twins_CSC the decoders 'sk_tam_v1', 'sk_tam_v3_noinit' and
``use_gma=False``) at iters=1, 128x256, T=4, test mode, with the same
random variables (running statistics too) on both sides: the port's bf16
flow (``mixed_precision=True``) against JAX's f32 flow within 1.5x of
JAX's own bf16 flow's relative EPE against the same f32 flow, global and
per-pixel p99 (``tools/common.py::rel_epe``, chip_smoke's bf16 guard
rule; tests/test_torch_raft_bf16.py's rule for the two-frame models).

JAX's ``corr_impl`` here is 'xla', what ``StreamFlowConfig.resolve()``
picks off a TPU (the test asserts it): its ``CorrPyramid`` averages the
bf16 fmaps' levels in f32 and rounds each level once. The port follows
the TPU path, 'pallas', whose ``pool_pyramid`` averages in bf16 (ROADMAP,
Known JAX behaviours), so its pyramid rounds more than the reference it
is held to here. bf16 checks on the CPU run at 128x256 or more (torch's
bf16 CPU convolution is wrong where an output side is 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import randomize_params
from streamflow_tpu.config import StreamFlowConfig as JaxConfig
from streamflow_tpu.models import create_model as jax_create
from streamflow_tpu_torch.config import StreamFlowConfig
from streamflow_tpu_torch.models import create_model
from streamflow_tpu_torch.params import load_jax
from streamflow_tpu_torch.tools.common import rel_epe

torch.set_num_threads(2)
T, H, W = 4, 128, 256
BF16_GUARD_RATIO = 1.5
CONFIGS = {"canonical": {},
           "twins": dict(encoder="twins"),
           "twins_1dconv": dict(encoder="twins_1dconv"),
           "twins_temporal_attention": dict(
               encoder="twins_temporal_attention"),
           "twins_3dconv": dict(encoder="twins_3dconv"),
           "basic": dict(encoder="basic"),
           "res18_3d": dict(encoder="res18_3d"),
           "sk_tam_v1": dict(update_block="sk_tam_v1"),
           "sk_tam_v3_noinit": dict(update_block="sk_tam_v3_noinit"),
           "no_gma": dict(use_gma=False)}


def _variables(jm, imgs, seed=1):
    """Random params, running means 0.1 r and variances 0.5 + u, from the
    init's shapes (nothing compiled)."""
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, test_mode=True),
                            jax.random.PRNGKey(0), jnp.asarray(imgs))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    v = {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        randomize_params(zeros["params"], seed))}
    if "batch_stats" in zeros:
        rng = np.random.default_rng(seed + 1)
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: (0.5 + rng.random(a.shape) if p[-1].key == "var"
                          else 0.1 * rng.standard_normal(a.shape)
                          ).astype(np.float32), zeros["batch_stats"])
    return v


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_streamflow_within_guard_of_jax(name):
    fields = CONFIGS[name]
    imgs = np.random.default_rng(0).integers(
        0, 255, (1, T, H, W, 3)).astype(np.float32)

    def jax_model(mixed_precision):
        return jax_create("streamflow", cfg=JaxConfig(
            T=T, iters=1, mixed_precision=mixed_precision, **fields))

    v = _variables(jax_model(False), imgs)

    def jax_flow(mixed_precision):
        m = jax_model(mixed_precision)
        assert m.cfg.resolve().corr_impl == "xla"
        return torch.from_numpy(np.array(jax.jit(
            lambda v, x: m.apply(v, x, test_mode=True))(
            v, jnp.asarray(imgs)), np.float32))

    ref, jax_bf16 = jax_flow(False), jax_flow(True)
    tm = create_model("streamflow", cfg=StreamFlowConfig(
        T=T, iters=1, mixed_precision=True, **fields), device="cpu")
    load_jax(tm, v)
    with torch.no_grad():
        got = tm(torch.from_numpy(imgs), test_mode=True)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    port, plain = rel_epe(got, ref), rel_epe(jax_bf16, ref)
    assert all(np.isfinite(port)), port
    assert all(p <= BF16_GUARD_RATIO * j for p, j in zip(port, plain)), (
        port, plain)
