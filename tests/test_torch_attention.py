"""K3 (flash attention forward): the port's plain version, which the CUDA
kernel is held against on the card, vs the JAX package's Pallas kernel
flash_attention_tpu in interpret mode (as tests/test_attention.py:54) and
its streaming composite _flash_xla, at d=32 and d=128 with kv lengths
that need padding (among them the CUDA kernel's tails: fewer keys than one
tile, a query count that is no multiple of its 128-row tile). CPU, f32, seeded numpy inputs. Tolerance 2e-4 abs/rel,
as tests/test_attention.py:58 (f32 softmax over a few hundred keys)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from streamflow_tpu.ops.pallas import _attention_kernel as ak
from streamflow_tpu.ops.pallas.attention import _flash_xla
from streamflow_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_plain)

torch.set_num_threads(2)
TOL = dict(atol=2e-4, rtol=2e-4)


def _qkv(seed, bh, nq, nk, d):
    rng = np.random.default_rng(seed)
    q = (d ** -0.5 * rng.standard_normal((*bh, nq, d))).astype(np.float32)
    k = rng.standard_normal((*bh, nk, d)).astype(np.float32)
    v = rng.standard_normal((*bh, nk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("bh,nq,nk,d", [((1, 4), 256, 200, 32),
                                        ((3, 1), 256, 384, 128),
                                        ((1, 2), 100, 130, 128),
                                        # tails of the CUDA kernel's tiles
                                        ((1, 4), 300, 1312, 32),
                                        ((1, 4), 300, 50, 32)])
def test_plain_matches_pallas_interpret(bh, nq, nk, d):
    q, k, v = _qkv(nq + nk + d, bh, nq, nk, d)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ak.flash_attention_tpu(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
            block_k=128))
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                kv_chunk=64, q_chunk=96).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    ref = np.asarray(_flash_xla(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), kv_chunk=64))
    np.testing.assert_allclose(got, ref, **TOL)


def test_cpu_wrapper_is_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(5, (2, 2), 70, 50, 32))
    np.testing.assert_array_equal(flash_attention(q, k, v).numpy(),
                                  flash_attention_plain(q, k, v).numpy())
