"""The port's training slice against the JAX package, on the CPU in f32 with
seeded numpy inputs and the same fan-in-scaled random weights (through the
bridge).

(c) ``sequence_loss`` (with invalid and >400 px pixels) and the OneCycle
    schedule against the JAX functions (1e-6 relative; the schedule also
    1e-7 of max_lr absolute, optax's f32 rounding near the end).
(d) One full train step at 64x96, T=4, iters=2 (gamma 0.85, lr 1.75e-4,
    AdamW, clip 1.0), with each SK layout (``dw_impl`` 'auto', 'pallas',
    'banded_mxu', 'banded_chain'), against ``make_train_step`` +
    ``make_optimizer`` of the same configuration (one JAX 'banded' step,
    run once, for both banded layouts: off a TPU JAX runs them all through
    its XLA banded composite):
    loss, metrics, the global gradient norm, every clipped gradient (JAX's
    from its Adam first moment, mu = (1 - b1) g after one step) and every
    parameter after the update. Random-weight flows reach ~1e3 px after
    two iterations (ROADMAP.md), so tolerances are relative: loss, metrics
    and norm 1e-4, each gradient 1e-4 of its leaf's largest element (f32
    backward sums in another order), each updated parameter 1e-2 of lr
    (Adam's first step is lr g / (|g| + eps), so an element's error
    follows its gradient's relative error, largest where |g| is tiny).
(e) remat gives the same gradients as no remat (exactly the same math);
    the bidirectional batch fold equals two applications (as
    tests/test_training_infra.py:227), port only, tolerance 1e-5.
(f) Importing the port and calling ``params.from_jax`` loads neither jax
    nor the JAX package; ``create_model`` puts the model on the card by
    default and raises without one.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import streamflow_pair
from streamflow_tpu.training import loss as JL
from streamflow_tpu.training import optim as JO
from streamflow_tpu.training.state import TrainState as JState
from streamflow_tpu.training.step import make_train_step as j_make_step
from streamflow_tpu_torch.config import StreamFlowConfig
from streamflow_tpu_torch.models import create_model
from streamflow_tpu_torch.params import _flatten, to_jax
from streamflow_tpu_torch.training.loss import sequence_loss
from streamflow_tpu_torch.training.optim import onecycle_linear
from streamflow_tpu_torch.training.state import TrainState
from streamflow_tpu_torch.training.step import make_loss_fn, make_train_step

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, GAMMA, ITERS = 1.75e-4, 0.85, 2


def _batch(seed, b, t, h, w, bidir=False):
    rng = np.random.default_rng(seed)
    f = t - 1
    batch = {"images": rng.integers(0, 255, (b, t, h, w, 3)).astype(
                 np.float32),
             "flows": (4.0 * rng.standard_normal((b, f, h, w, 2))).astype(
                 np.float32),
             "valids": (rng.random((b, f, h, w)) > 0.1).astype(np.float32)}
    batch["flows"][:, :, :3, :5] = 450.0    # above MAX_FLOW: excluded
    if bidir:
        batch["flows_bw"] = (0.1 * rng.standard_normal((b, f, h, w, 2))
                             ).astype(np.float32)
        batch["valids_bw"] = np.ones((b, f, h, w), np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------------ (c)
@pytest.mark.parametrize("shape", [(3, 2, 12, 16), (2, 1, 2, 8, 12)])
def test_sequence_loss_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    preds = (5.0 * rng.standard_normal((*shape, 2))).astype(np.float32)
    gt = (5.0 * rng.standard_normal((*shape[1:], 2))).astype(np.float32)
    gt[..., :2, :3, :] = 500.0                                # > MAX_FLOW
    valid = (rng.random(shape[1:]) > 0.3).astype(np.float32)
    want, wm = JL.sequence_loss(jnp.asarray(preds), jnp.asarray(gt),
                                jnp.asarray(valid), GAMMA)
    got, gm = sequence_loss(torch.from_numpy(preds), torch.from_numpy(gt),
                            torch.from_numpy(valid), GAMMA)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for k in ("epe", "1px", "3px", "5px"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6)


def test_onecycle_schedule_matches_optax():
    total = 180_000 + 100
    warm = int(total * 0.05)
    want = JO.onecycle_linear(LR, total)
    got = onecycle_linear(LR, total)
    for s in (0, 1, warm - 1, warm, warm + 1, (warm + total) // 2, total - 1,
              total, total + 50):
        # optax evaluates in f32: its rounding is ~1e-7 of max_lr
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6,
                                   atol=1e-7 * LR, err_msg=f"step {s}")


# ------------------------------------------------------------------ (d)
_JAX_STEPS = {}


@pytest.fixture(scope="module", params=["auto", "pallas", "banded_mxu",
                                        "banded_chain"])
def one_step(request):
    """One train step of each package from the same weights and batch, with
    each SK layout (dw_impl 'auto', the edge-fused default; 'pallas', the
    dw-chain layout; 'banded_mxu' and 'banded_chain', against JAX's
    'banded' step, run once for both)."""
    jm, params, tm, _ = streamflow_pair(iters=ITERS, train=True,
                                        dw_impl=request.param)
    batch = _batch(5, 1, 4, 64, 96)
    if id(jm) not in _JAX_STEPS:
        tx = JO.make_optimizer(LR, 100)
        jstep = jax.jit(j_make_step(jm, tx, gamma=GAMMA, iters=ITERS))
        _JAX_STEPS[id(jm)] = jstep(
            JState.create(params, tx),
            {k: jnp.asarray(v) for k, v in batch.items()})
    jstate, jmet = _JAX_STEPS[id(jm)]
    state = TrainState.create(tm, lr=LR, num_steps=100)
    met = make_train_step(GAMMA, ITERS)(state, _torch(batch))
    return params, jstate, jmet, tm, met


def test_train_step_loss_and_metrics_match_jax(one_step):
    _, _, jmet, _, met = one_step
    for k in ("loss", "grad_norm", "epe", "1px", "3px", "5px"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(met["grad_norm"]) > 1.0        # clipping is active


def _mu(opt_state):
    """Adam's first moment from the optax chain's state."""
    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(node, "mu"):
            return node.mu
    raise AssertionError("no Adam state")


def test_train_step_gradients_match_jax(one_step):
    _, jstate, _, tm, _ = one_step
    want = _flatten(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, _mu(jstate.opt_state))["params"])
    got = to_jax({n: p.grad for n, p in tm.named_parameters()})
    assert set(got) == set(want)
    for path, g in got.items():
        w = want[path]
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-12),
                                   err_msg=path)


def test_train_step_updated_params_match_jax(one_step):
    params, jstate, _, tm, _ = one_step
    want = _flatten(jax.tree_util.tree_map(np.asarray,
                                           jstate.params["params"]))
    before = _flatten(params["params"])
    got = to_jax(tm.state_dict())
    assert set(got) == set(want)
    for path, p in got.items():
        np.testing.assert_allclose(p, want[path], rtol=0, atol=1e-2 * LR,
                                   err_msg=path)
        assert not np.array_equal(p, before[path]), f"{path} did not move"


# ------------------------------------------------------------------ (e)
def _grads(model, loss_fn, batch):
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in
                         model.named_parameters()}


def _port_model(remat):
    torch.manual_seed(0)
    cfg = StreamFlowConfig(T=4, iters=1, mixed_precision=False, remat=remat)
    return create_model("streamflow", cfg=cfg, device="cpu", train=True)


def test_remat_gives_the_same_gradients():
    batch = _torch(_batch(6, 1, 4, 32, 48))
    loss_fn = make_loss_fn(GAMMA, 2)
    l0, g0 = _grads(_port_model(False), loss_fn, batch)
    l1, g1 = _grads(_port_model(True), loss_fn, batch)
    assert l0 == l1
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-7,
                                   msg=n)


def test_bidirectional_fold_equals_two_applications():
    model = _port_model(False)
    batch = _torch(_batch(7, 2, 4, 32, 32, bidir=True))
    folded, gf = _grads(model, make_loss_fn(GAMMA, 1, bidirectional=True),
                        batch)
    fwd = make_loss_fn(GAMMA, 1)
    rev = {"images": batch["images"].flip(1),
           "flows": batch["flows_bw"].flip(1),
           "valids": batch["valids_bw"].flip(1)}
    l_f, g_f = _grads(model, fwd, batch)
    l_b, g_b = _grads(model, fwd, rev)
    np.testing.assert_allclose(folded, l_f + l_b, rtol=1e-5)
    for n in gf:
        torch.testing.assert_close(gf[n], g_f[n] + g_b[n], rtol=1e-5,
                                   atol=1e-6, msg=n)


# ------------------------------------------------------------------ (f)
def test_port_and_from_jax_load_neither_jax_nor_the_jax_package():
    code = """
import sys
import numpy as np
import torch
import streamflow_tpu_torch
from streamflow_tpu_torch.config import StreamFlowConfig
from streamflow_tpu_torch.models import create_model
from streamflow_tpu_torch.params import from_jax, to_jax

model = create_model("streamflow", cfg=StreamFlowConfig(), device="cpu")
tree = {}
for path, value in to_jax(model.state_dict()).items():
    node = tree
    *parents, leaf = path.split("/")
    for p in parents:
        node = node.setdefault(p, {})
    node[leaf] = value
sd = from_jax({"params": tree})
assert set(sd) == set(model.state_dict())
assert "jax" not in sys.modules, "jax imported"
bad = [m for m in sys.modules if m.split(".")[0] == "streamflow_tpu"]
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_create_model_defaults_to_the_card():
    cfg = StreamFlowConfig(T=4, iters=1)
    if torch.cuda.is_available():
        model = create_model("streamflow", cfg=cfg)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model("streamflow", cfg=cfg)
    cpu = create_model("streamflow", cfg=cfg, device="cpu", train=True)
    p = next(cpu.parameters())
    assert p.device.type == "cpu" and p.dtype == torch.float32
    assert p.requires_grad and cpu.training
