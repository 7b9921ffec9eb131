"""K4 (Twins locally-grouped attention): the port's plain version, which
the CUDA kernel is held against on the card, vs the JAX package's Pallas
kernel lga_attention in interpret mode, and the port's LocallyGroupedAttn
module vs the JAX module on a grid that needs padding (padded tokens hold
qkv = bias and are not masked). CPU, f32, seeded numpy inputs. Tolerance
2e-4 abs/rel, as tests/test_lga_kernel.py:40."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamflow_tpu.layers.twins import LocallyGroupedAttn as JLGA
from streamflow_tpu.ops.pallas._lga_kernel import lga_attention as j_lga
from streamflow_tpu_torch.layers.twins import LocallyGroupedAttn
from streamflow_tpu_torch.ops.kernels.lga_attention import (
    lga_attention_plain)
from streamflow_tpu_torch.params import _to_torch_layout

torch.set_num_threads(2)
TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("shape,nh,ws", [((1, 14, 21, 384), 4, 7),
                                         ((2, 7, 14, 768), 8, 7),
                                         ((1, 10, 15, 384), 4, 5)])
def test_plain_matches_pallas_interpret(shape, nh, ws):
    qkv = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    want = np.asarray(j_lga(jnp.asarray(qkv), ws=ws, nh=nh, interpret=True))
    got = lga_attention_plain(torch.from_numpy(qkv), ws, nh).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_module_matches_jax_on_padded_grid():
    rng = np.random.default_rng(3)
    ht, w, c = 11, 18, 128
    x = rng.standard_normal((2, ht * w, c)).astype(np.float32)
    jm = JLGA(c, 4, ws=7, impl="xla")
    params = jax.tree_util.tree_map(
        lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32),
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x), (ht, w)))
    want = np.asarray(jm.apply(params, jnp.asarray(x), (ht, w)))
    m = LocallyGroupedAttn(c, 4, 7)
    p = params["params"]
    with torch.no_grad():
        for name in ("qkv", "proj"):
            lin = getattr(m, name)
            lin.weight.copy_(torch.from_numpy(_to_torch_layout(
                "linear", np.asarray(p[name]["kernel"]))))
            lin.bias.copy_(torch.from_numpy(np.asarray(p[name]["bias"])))
        got = m(torch.from_numpy(x), (ht, w)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
