"""The port's StreamFlow end to end against the JAX package's, with the same
fan-in-scaled random weights through the bridge, at 64x96, T=4, iters=2,
f32 on the CPU, in each SK layout (dw_impl 'auto', 'pallas' and the banded
family; one JAX 'banded' model, run once, serves the four banded layouts,
since off a TPU they all run JAX's XLA banded composite). iters <= 2:
random-weight dynamics amplify rounding about 2.7x per iteration
(ROADMAP.md). Flows reach ~1e3 px, so the tolerance is
relative to the largest flow: 1e-5 of it, plus 1e-4 rtol. Also: the weight
bridge's completeness checks, the warm start, that the port never imports
jax, and that chip_smoke.py refuses to run without CUDA."""

import ast
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import streamflow_pair
from streamflow_tpu_torch.params import from_jax, load_jax

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=["auto", "pallas", "banded_mxu",
                                        "banded_mxu_t", "banded_chain",
                                        "banded"])
def pair(request):
    """Both packages built with each SK layout (dw_impl 'auto', the
    edge-fused default; 'pallas', the dw-chain layout; the banded family,
    against JAX's 'banded' model)."""
    return streamflow_pair(dw_impl=request.param)


_JAX_RUNS = {}


def _jax_once(jm, name, fn):
    """fn()'s result, computed once per JAX model (the banded layouts share
    theirs) and test."""
    key = (id(jm), name)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = fn()
    return _JAX_RUNS[key]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def test_streamflow_test_mode_matches_jax(pair):
    jm, params, tm, imgs = pair
    want = _jax_once(jm, "test_mode", lambda: jax.jit(
        lambda p, x: jm.apply(p, x, test_mode=True))(params,
                                                      jnp.asarray(imgs)))
    got = tm(torch.from_numpy(imgs))
    assert got.shape == (1, 3, 64, 96, 2) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_streamflow_flow_init_matches_jax(pair):
    jm, params, tm, imgs = pair
    finit = (4.0 * np.random.default_rng(9).standard_normal(
        (1, 3, 8, 12, 2))).astype(np.float32)
    flows, low = _jax_once(jm, "flow_init", lambda: jax.jit(
        lambda p, x, f: jm.apply(p, x, test_mode=True, flow_init=f))(
            params, jnp.asarray(imgs), jnp.asarray(finit)))
    gflows, glow = tm(torch.from_numpy(imgs), flow_init=torch.from_numpy(finit))
    assert glow.shape == (1, 3, 8, 12, 2)
    _close(gflows.numpy(), flows)
    _close(glow.numpy(), low)


def test_bridge_raises_on_unused_leaf_and_unset_parameter(pair):
    jm, params, tm, imgs = pair
    extra = {"params": dict(params["params"], stray={"kernel": np.zeros(3)})}
    with pytest.raises(KeyError, match="unused"):
        from_jax(extra)
    fnet = dict(params["params"]["fnet"])
    del fnet["stages"]
    with pytest.raises(KeyError, match="lack"):
        from_jax({"params": dict(params["params"], fnet=fnet)})
    tm.register_parameter("unset", torch.nn.Parameter(torch.zeros(1)))
    try:
        with pytest.raises(KeyError, match="unset"):
            load_jax(tm, params)
    finally:
        del tm.unset
    sd = from_jax(params)
    assert set(sd) == set(tm.state_dict())


def test_port_never_imports_jax():
    """Importing the port loads neither jax nor the JAX package."""
    code = ("import sys, streamflow_tpu_torch, streamflow_tpu_torch.models, "
            "streamflow_tpu_torch.params, streamflow_tpu_torch.ops.kernels."
            "corr_lookup, streamflow_tpu_torch.ops.kernels.dw_chain, "
            "streamflow_tpu_torch.ops.kernels.dw_banded, "
            "streamflow_tpu_torch.tools.train_bench; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "bad = [m for m in sys.modules if m.split('.')[0] == "
            "'streamflow_tpu']; assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert "streamflow_tpu_torch.models" in names
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "flax", "streamflow_tpu"}, names


def test_config_mirrors_the_jax_config():
    """The port's StreamFlowConfig has the JAX package's fields, defaults
    and derived widths, so one dict of keyword arguments builds both."""
    import dataclasses

    from streamflow_tpu.config import StreamFlowConfig as JaxConfig
    from streamflow_tpu_torch.config import StreamFlowConfig

    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    assert fields(StreamFlowConfig) == fields(JaxConfig)
    kw = dict(T=3, decoder_dim=192, corr_levels=3, corr_radius=3)
    port, ref = StreamFlowConfig(**kw), JaxConfig(**kw)
    for prop in ("hidden_dim", "context_dim", "ratio", "corr_planes"):
        assert getattr(port, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda(tmp_path, alone):
    """Without a card (or outside a checkout) the script exits non-zero and
    prints no result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    else:
        cwd = ROOT
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
