"""The channel-major FFN pair (``ops/kernels/ffn_pair_cmajor.py``, the port
of tools/probe_cmajor_ffn.py's Pallas kernel): its plain version against
the JAX tool's ``ffn_pair_cmajor(..., interpret=True)`` and against JAX's
row-major kernel (``_ffn_pair_fwd``, interpret mode) on the transpose,
CPU, f32, seeded numpy inputs, tolerance 5e-5 (tests/test_ffn_kernel.py's).
The JAX tool imports a gelu its module no longer has (``_gelu``): the
test sets that name to the kernel's erf (or poly) gelu first, on the test
side only."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamflow_tpu.ops.pallas import _ffn_kernel as K
from streamflow_tpu_torch.ops.kernels import LAUNCHES
from streamflow_tpu_torch.ops.kernels import ffn_pair_cmajor as KC

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=5e-5, rtol=5e-5)


def _jax_tool(monkeypatch, gelu):
    monkeypatch.setattr(K, "_gelu", K._GELUS[gelu], raising=False)
    spec = importlib.util.spec_from_file_location(
        f"jax_probe_cmajor_{gelu}", ROOT / "tools" / "probe_cmajor_ffn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(c, ch, co, n, seed):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((c, n))).astype(np.float32)
    w1 = (rng.standard_normal((c, ch)) / np.sqrt(c)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(ch)).astype(np.float32)
    w2 = (rng.standard_normal((ch, co)) / np.sqrt(ch)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(co)).astype(np.float32)
    return x, w1, b1, w2, b2


def _port(x, w1, b1, w2, b2, residual, gelu):
    t = torch.from_numpy
    return KC.ffn_pair_cmajor(t(x), t(w1.T.copy()), t(b1), t(w2.T.copy()),
                              t(b2), residual=residual, gelu=gelu).numpy()


@pytest.mark.parametrize("gelu", ["erf", "poly"])
@pytest.mark.parametrize("residual,co", [(True, 96), (False, 48)])
def test_plain_matches_the_jax_cmajor_kernel(monkeypatch, residual, co,
                                             gelu):
    tool = _jax_tool(monkeypatch, gelu)
    c = 96 if residual else 64
    ops = _operands(c, 160, co, 512, seed=co + residual)
    want = np.asarray(tool.ffn_pair_cmajor(
        *map(jnp.asarray, ops), residual=residual, block_n=256,
        interpret=True))
    got = _port(*ops, residual, gelu)
    assert got.shape == (co, 512)
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_matches_the_row_major_kernel_on_the_transpose():
    x, w1, b1, w2, b2 = _operands(128, 192, 128, 384, seed=7)
    want = np.asarray(K._ffn_pair_fwd(
        *map(jnp.asarray, (x.T.copy(), w1, b1, w2, b2)), residual=True,
        block_n=256, interpret=True))
    got = _port(x, w1, b1, w2, b2, True, "erf")
    np.testing.assert_allclose(got.T, want, **TOL)


def test_cpu_calls_launch_nothing_and_shapes_are_checked():
    x = torch.randn(32, 40)
    w1, w2 = torch.randn(48, 32), torch.randn(32, 48)
    before = dict(LAUNCHES)
    y = KC.ffn_pair_cmajor(x, w1, torch.zeros(48), w2, torch.zeros(32))
    assert y.shape == (32, 40) and LAUNCHES == before
    with pytest.raises(ValueError):   # a residual needs C_out == C_in
        KC.ffn_pair_cmajor(x, w1, torch.zeros(48), torch.randn(16, 48),
                           torch.zeros(16))
