"""The trainer's stage forms of the port's train step against the JAX
package's, on the CPU in f32 with the same fan-in-scaled random weights
and seeded batch (tests/test_torch_train.py's setting and tolerances:
loss, metrics and gradient norm 1e-4 relative; each gradient 1e-4 of its
leaf's largest element; each updated parameter 1e-2 of lr, plus what the
gradient's own tolerance e moves Adam's first update lr g / (|g| + eps)
by, lr eps e / (|g| + eps)^2: negligible but where |g| is near eps,
where a gradient within its tolerance may move the update by up to lr/4;
at T=3 one element of 13.8M has |g| ~ 1e-8):

- the kitti stage, ``kitti_last_pair_only`` at T=4: only the last pair is
  supervised;
- T=3, the things and bithings presets' clip length: one test-mode
  forward (test_torch_model.py's tolerance: rtol 1e-4, atol 1e-5
  max|flow|) and one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import streamflow_pair
from test_torch_train import GAMMA, ITERS, LR, _batch, _mu, _torch

from streamflow_tpu.training import optim as JO
from streamflow_tpu.training.state import TrainState as JState
from streamflow_tpu.training.step import make_train_step as j_make_step
from streamflow_tpu_torch.params import _flatten, to_jax
from streamflow_tpu_torch.training.state import TrainState
from streamflow_tpu_torch.training.step import make_train_step

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=[("kitti", 4), ("T3", 3)],
                ids=["kitti_last_pair_T4", "T3"])
def one_step(request):
    """One train step of each package from the same weights and batch."""
    stage, t = request.param
    kitti = stage == "kitti"
    jm, params, tm, _ = streamflow_pair(T=t, iters=ITERS, train=True)
    batch = _batch(8, 1, t, 64, 96)
    if kitti:   # KITTI's ground truth is on the last pair only
        batch["valids"][:, :-1] = 0.0
        batch["flows"][:, :-1] = 0.0
    tx = JO.make_optimizer(LR, 100)
    jstate, jmet = jax.jit(j_make_step(
        jm, tx, gamma=GAMMA, iters=ITERS, kitti_last_pair_only=kitti))(
        JState.create(params, tx),
        {k: jnp.asarray(v) for k, v in batch.items()})
    state = TrainState.create(tm, lr=LR, num_steps=100)
    met = make_train_step(GAMMA, ITERS, kitti_last_pair_only=kitti)(
        state, _torch(batch))
    return stage, params, jstate, jmet, tm, met


def test_step_loss_and_metrics_match_jax(one_step):
    stage, _, _, jmet, _, met = one_step
    for k in ("loss", "grad_norm", "epe", "1px", "3px", "5px"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(met["grad_norm"]) > 1.0        # clipping is active
    if stage == "kitti":   # the epe is the supervised last pair's
        assert float(met["epe"]) > 0.0


def test_step_gradients_match_jax(one_step):
    _, _, jstate, _, tm, _ = one_step
    want = _flatten(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, _mu(jstate.opt_state))["params"])
    got = to_jax({n: p.grad for n, p in tm.named_parameters()})
    assert set(got) == set(want)
    for path, g in got.items():
        w = want[path]
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-12),
                                   err_msg=path)


def test_step_updated_params_match_jax(one_step):
    _, params, jstate, _, tm, _ = one_step
    want = _flatten(jax.tree_util.tree_map(np.asarray,
                                           jstate.params["params"]))
    grads = _flatten(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, _mu(jstate.opt_state))["params"])
    before = _flatten(params["params"])
    got = to_jax(tm.state_dict())
    assert set(got) == set(want)
    eps = 1e-8
    for path, p in got.items():
        g = np.abs(grads[path])
        e = 1e-4 * max(g.max(), 1e-12) + 1e-4 * g     # the gradient's tol
        tol = 1e-2 * LR + LR * eps * e / (g + eps) ** 2
        err = np.abs(p - want[path])
        assert (err <= tol).all(), (path, float(err.max()),
                                    float((err / tol).max()))
        assert not np.array_equal(p, before[path]), f"{path} did not move"


def test_kitti_last_pair_loss_ignores_the_other_pairs():
    """With ``kitti_last_pair_only`` the loss reads the last pair's ground
    truth alone: changing the others' leaves it as it was."""
    from streamflow_tpu_torch.training.step import make_loss_fn

    _, _, tm, _ = streamflow_pair(T=4, iters=ITERS, train=True)
    batch = _torch(_batch(9, 1, 4, 64, 96))
    loss_fn = make_loss_fn(GAMMA, ITERS, kitti_last_pair_only=True)
    with torch.no_grad():
        a, _ = loss_fn(tm, batch)
        batch["flows"][:, :-1] += 3.0
        batch["valids"][:, :-1] = 1.0 - batch["valids"][:, :-1]
        b, _ = loss_fn(tm, batch)
        c, _ = make_loss_fn(GAMMA, ITERS)(tm, batch)
    assert float(a) == float(b) and float(c) > float(b)


def test_t3_forward_matches_jax():
    jm, params, tm, imgs = streamflow_pair(T=3, iters=ITERS)
    got = tm(torch.from_numpy(imgs), test_mode=True).numpy()
    want = np.asarray(jax.jit(lambda p, x: jm.apply(
        p, x, iters=ITERS, test_mode=True))(params, jnp.asarray(imgs)))
    assert got.shape == want.shape == (1, 2, 64, 96, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
