"""The port's UMT train step (``encoder="umt"``, ``decoder_dim=768``)
against the JAX package's, on the CPU in f32, with seeded numpy inputs and
the same random weights (through the bridge).

(a) One train step at 1x4x64x128 (a 4x8 grid at UMT's ratio 16), iters 2,
    remat on, gamma 0.85, lr 1.75e-4, AdamW, clip 1.0, every parameter
    random from a seed on both sides (``_torch_parity.randomize_params`` on
    the JAX init's shapes, loaded into the port by ``params.load_jax``),
    against ``make_train_step`` + ``make_optimizer`` of the same
    configuration. It checks the loss, the metrics and the global gradient
    norm (1e-4 relative, tests/test_torch_train.py's bound), every clipped
    gradient (JAX's from its Adam first moment, mu = (1 - b1) g after one
    step) and every updated parameter. The port's step runs K3 and its
    backward B5 at head dims 64 (the ViT's 12 heads) and 384 (GMA), K1 at
    C=768 and K2's wide path through their plain versions here; JAX's runs
    its XLA attention and lookup.

    This step is worse conditioned than the canonical one: its random
    weights drive the flows to ~800 px EPE after two iterations through
    a decoder three times as wide, and a relative 1e-6 move of every
    weight (f32 rounding of the weights) moves the port's own gradients by
    up to 1.8e-4 relative L2 a leaf (median 4.8e-5), and 104 of its 204
    leaves by more than 1e-4 of their largest element somewhere. So each
    gradient is held as chip_smoke.py's training guard holds them (and
    tests/test_torch_zoo_train.py its ill-conditioned leaves): a relative
    L2 error of at most GRAD_TOL = 1e-4 plus PERTURB_SLACK = 4 times that
    leaf's own change under such a perturbation, the largest of three
    random directions (read: at most 0.47 of this bound); a dropped or
    misrouted gradient is O(1). Each updated
    parameter within 1e-2 lr of JAX's plus what the two sides' gradient
    difference makes of AdamW's first step, lr g / (|g| + eps): at most
    lr |dg| eps / (min |g| + eps)^2 an element (clipped elements near
    |g| ~ eps, tests/test_torch_zoo_train.py's rule).
(b) remat gives the same loss and gradients as no remat on the UMT model
    (the same math recomputed), port only, 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import randomize_params
from streamflow_tpu.config import StreamFlowConfig as JaxConfig
from streamflow_tpu.models import create_model as jax_create
from streamflow_tpu.training import optim as JO
from streamflow_tpu.training.state import TrainState as JState
from streamflow_tpu.training.step import make_train_step as j_make_step
from streamflow_tpu_torch.config import StreamFlowConfig
from streamflow_tpu_torch.models import create_model
from streamflow_tpu_torch.params import _flatten, load_jax, to_jax
from streamflow_tpu_torch.training.state import TrainState
from streamflow_tpu_torch.training.step import make_loss_fn, make_train_step

torch.set_num_threads(2)
LR, GAMMA, ITERS = 1.75e-4, 0.85, 2
GRAD_TOL, PERTURB, PERTURB_SLACK, SEED_PERTURB = 1e-4, 1e-6, 4.0, 2
PERTURB_DRAWS = 3
EPS = 1e-8              # AdamW's epsilon (both packages' default)
T, H, W = 4, 64, 128
UMT_KW = dict(T=T, iters=ITERS, mixed_precision=False, encoder="umt",
              decoder_dim=768)


def _batch(seed, b=1, t=T, h=H, w=W):
    rng = np.random.default_rng(seed)
    f = t - 1
    batch = {"images": rng.integers(0, 255, (b, t, h, w, 3)).astype(
                 np.float32),
             "flows": (4.0 * rng.standard_normal((b, f, h, w, 2))).astype(
                 np.float32),
             "valids": (rng.random((b, f, h, w)) > 0.1).astype(np.float32)}
    batch["flows"][:, :, :3, :5] = 450.0    # above MAX_FLOW: excluded
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _variables(jm, seed=1):
    """Random params from the init's shapes (nothing compiled)."""
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, test_mode=True),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, T, H, W, 3), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    return {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        randomize_params(zeros["params"], seed))}


def _mu(opt_state):
    """Adam's first moment from the optax chain's state."""
    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(node, "mu"):
            return node.mu
    raise AssertionError("no Adam state")


def _port(v, remat=True):
    tm = create_model("streamflow", cfg=StreamFlowConfig(remat=remat,
                                                         **UMT_KW),
                      device="cpu", train=True)
    load_jax(tm, v)
    return tm


def _sensitivity(model, batch):
    """Per flax path, the largest relative L2 change of the port's gradient
    when every weight of ``model`` (copies of it) moves by a relative
    PERTURB in one of PERTURB_DRAWS random directions (one direction
    under-reads some leaves by 2-3x)."""
    loss_fn = make_loss_fn(GAMMA, ITERS)
    g = torch.Generator().manual_seed(SEED_PERTURB)
    grads = []
    for eps in (0.0,) + (PERTURB,) * PERTURB_DRAWS:
        m = copy.deepcopy(model)
        with torch.no_grad():
            for p in m.parameters():
                p.mul_(1 + eps * torch.randn(p.shape, generator=g))
        loss, _ = loss_fn(m, batch)
        loss.backward()
        grads.append(to_jax({n: p.grad for n, p in m.named_parameters()},
                            cfg=m.cfg))
    return {k: max(float(np.linalg.norm(gp[k] - g0)
                         / max(np.linalg.norm(g0), 1e-30))
                   for gp in grads[1:])
            for k, g0 in grads[0].items()}


@pytest.fixture(scope="module")
def one_step():
    """One train step of each package from the same weights and batch:
    (variables, JAX state, JAX metrics, port model, port metrics, the
    port's gradient sensitivity per leaf)."""
    jm = jax_create("streamflow", cfg=JaxConfig(remat=True, **UMT_KW))
    v = _variables(jm)
    batch = _batch(5)
    tx = JO.make_optimizer(LR, 100)
    jstep = jax.jit(j_make_step(jm, tx, gamma=GAMMA, iters=ITERS))
    jstate, jmet = jstep(JState.create(v, tx),
                         {k: jnp.asarray(a) for k, a in batch.items()})
    tm = _port(v)
    sens = _sensitivity(tm, _torch(batch))
    state = TrainState.create(tm, lr=LR, num_steps=100)
    met = make_train_step(GAMMA, ITERS)(state, _torch(batch))
    return v, jstate, jmet, tm, met, sens


def _jax_grads(jstate):
    """JAX's clipped gradients, from its Adam first moment."""
    return _flatten(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, _mu(jstate.opt_state))["params"])


# ------------------------------------------------------------------ (a)
def test_umt_train_step_loss_and_metrics_match_jax(one_step):
    _, _, jmet, _, met, _ = one_step
    for k in ("loss", "grad_norm", "epe", "1px", "3px", "5px"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(met["grad_norm"]) > 1.0        # clipping is active


def test_umt_train_step_gradients_match_jax(one_step):
    _, jstate, _, tm, _, sens = one_step
    want = _jax_grads(jstate)
    got = to_jax({n: p.grad for n, p in tm.named_parameters()}, cfg=tm.cfg)
    assert set(got) == set(want) == set(sens)
    for path, g in got.items():
        w = want[path]
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= GRAD_TOL + PERTURB_SLACK * sens[path], (
            path, err, sens[path])


def test_umt_train_step_updated_params_match_jax(one_step):
    v, jstate, _, tm, _, _ = one_step
    want = _flatten(jax.tree_util.tree_map(np.asarray,
                                           jstate.params["params"]))
    before = _flatten(v["params"])
    got = to_jax(tm.state_dict(), cfg=tm.cfg)
    g_port = to_jax({n: p.grad for n, p in tm.named_parameters()},
                    cfg=tm.cfg)
    g_jax = _jax_grads(jstate)
    assert set(got) == set(want)
    for path, p in got.items():
        gp, gj = g_port[path], g_jax[path]
        slack = LR * np.abs(gp - gj) * EPS / (
            np.minimum(np.abs(gp), np.abs(gj)) + EPS) ** 2
        assert (np.abs(p - want[path]) <= 1e-2 * LR + slack).all(), path
        assert not np.array_equal(p, before[path]), f"{path} did not move"


# ------------------------------------------------------------------ (b)
def _grads(model, batch):
    model.zero_grad(set_to_none=True)
    loss, _ = make_loss_fn(GAMMA, ITERS)(model, batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in
                                  model.named_parameters()}


def test_umt_remat_gives_the_same_gradients(one_step):
    v = one_step[0]
    batch = _torch(_batch(6))
    l0, g0 = _grads(_port(v, remat=False), batch)
    l1, g1 = _grads(_port(v, remat=True), batch)
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    assert set(g1) == set(g0)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-7,
                                   msg=n)
