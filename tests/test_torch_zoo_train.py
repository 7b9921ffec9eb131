"""The port's training of the ablation configs against the JAX package's,
on the CPU in f32, with seeded numpy inputs and the same random weights
and running statistics (through the bridge).

(a) One bidirectional train step at 64x96, T=4, iters=2 (gamma 0.85, lr
    1.75e-4, AdamW, clip 1.0) against JAX's ``make_train_step``: for
    ``encoder="basic"``, whose BatchNorm cnet takes the two-application
    path (both applications from the pre-step statistics, the second's
    update kept), and for ``twins_temporal_attention``, which folds the
    reversed clip into the batch. Loss, metrics and the gradients' norm
    1e-4 relative; each clipped gradient (JAX's from its Adam first
    moment) 1e-4 of its leaf's largest element; each updated parameter
    1e-2 of lr (tests/test_torch_train.py's bounds and reasons); the
    updated ``batch_stats`` 1e-5. A conv bias that feeds a norm (instance
    norm, or BatchNorm on batch statistics: the CNN encoders' conv1 and
    their blocks' convs) has a gradient of zero in exact arithmetic, so
    both sides' are rounding noise: each is held to 1e-6 of the largest
    gradient element, and, since AdamW's first step is lr g / (|g| +
    1e-8), each side's bias moves by less than lr / 10. The cnet's
    gradients through BatchNorm's batch statistics are small sums that
    cancel (its backward subtracts the per-channel mean of the incoming
    gradient and its projection on the normalised input), so they
    amplify any difference in what reaches them: a relative 1e-5 move of
    every weight, the size of the two packages' difference on the
    well-conditioned leaves (~1e-5 relative L2, the decoder's and fnet's
    leaves here), moves some of them by ~1e-1 (relative L2) on these
    weights, and the packages differ there by ~1e-2. A leaf whose
    gradient moves by more than 1e-4 under that perturbation is held to
    a relative L2 error of 1e-4 + 4 times that move, as chip_smoke.py's
    training guard holds every leaf; a dropped or misrouted gradient is
    O(1). (The Twins config has no BatchNorm: every leaf elementwise.) BatchNorm's own backward is held tightly on its own
    (tests/test_torch_zoo_encoders.py).
"""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import randomize_params
from streamflow_tpu.config import StreamFlowConfig as JaxConfig
from streamflow_tpu.models import create_model as jax_create
from streamflow_tpu.training import checkpoint as jckpt
from streamflow_tpu.training import optim as JO
from streamflow_tpu.training.state import TrainState as JState
from streamflow_tpu.training.step import make_train_step as j_make_step
from streamflow_tpu_torch.config import StreamFlowConfig
from streamflow_tpu_torch.evaluation import GraphedForward, window_flows
from streamflow_tpu_torch.layers.common import BatchNorm
from streamflow_tpu_torch.models import create_model
from streamflow_tpu_torch.params import (_flatten, load_jax, to_jax,
                                         to_jax_variables)
from streamflow_tpu_torch.tools.common import init_weights
from streamflow_tpu_torch.training import checkpoint
from streamflow_tpu_torch.training.state import TrainState
from streamflow_tpu_torch.training.step import (batch_stats, make_loss_fn,
                                                make_train_step)

torch.set_num_threads(2)
LR, GAMMA, ITERS = 1.75e-4, 0.85, 2
T, H, W = 4, 64, 96


def _batch(seed, b=1, t=T, h=H, w=W):
    rng = np.random.default_rng(seed)
    f = t - 1
    return {"images": rng.integers(0, 255, (b, t, h, w, 3)).astype(
                np.float32),
            "flows": (4.0 * rng.standard_normal((b, f, h, w, 2))).astype(
                np.float32),
            "valids": (rng.random((b, f, h, w)) > 0.1).astype(np.float32),
            "flows_bw": (4.0 * rng.standard_normal((b, f, h, w, 2))).astype(
                np.float32),
            "valids_bw": (rng.random((b, f, h, w)) > 0.1).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _variables(jm, seed=1):
    """Random params, running means 0.1 r and variances 0.5 + u, from the
    init's shapes (nothing compiled)."""
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, test_mode=True),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, T, H, W, 3), jnp.float32))
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


# conv biases followed by a norm that removes them (flax paths)
NOISE = re.compile(r"(fnet|cnet)/enc/(conv1|layer\d_\d/(conv1|conv2|"
                   r"downsample))/bias")


SEED_PERTURB = 2
PERTURB, SENSITIVE, PERTURB_SLACK = 1e-5, 1e-4, 4.0
EPS = 1e-8              # AdamW's epsilon (both packages' default)


def _mu(opt_state):
    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(node, "mu"):
            return node.mu
    raise AssertionError("no Adam state")


@pytest.fixture(scope="module",
                params=["basic", "twins_temporal_attention"])
def one_step(request):
    return two_steps(request.param)


def two_steps(encoder):
    """One bidirectional train step of each package from the same weights,
    statistics and batch: (variables, JAX state, JAX metrics, port model,
    port metrics)."""
    kw = dict(T=T, iters=ITERS, mixed_precision=False, encoder=encoder)
    jm = jax_create("streamflow", cfg=JaxConfig(**kw))
    v = _variables(jm)
    batch = _batch(5)
    tx = JO.make_optimizer(LR, 100)
    jstep = jax.jit(j_make_step(jm, tx, gamma=GAMMA, iters=ITERS,
                                bidirectional=True))
    jstate = JState.create({"params": v["params"]}, tx, model_state={
        k: w for k, w in v.items() if k != "params"})
    jstate, jmet = jstep(jstate, {k: jnp.asarray(a)
                                  for k, a in batch.items()})
    tm = create_model("streamflow", cfg=StreamFlowConfig(**kw), device="cpu",
                      train=True)
    load_jax(tm, v)
    sens = _sensitivity(tm, _torch(batch)) if "batch_stats" in v else {}
    state = TrainState.create(tm, lr=LR, num_steps=100)
    met = make_train_step(GAMMA, ITERS, bidirectional=True)(state,
                                                            _torch(batch))
    return v, jstate, jmet, tm, met, sens


def _sensitivity(model, batch):
    """Per flax path, the relative L2 change of the port's gradient when
    every weight moves by a relative PERTURB (chip_smoke.py's training
    guard), from copies of ``model``."""
    loss_fn = make_loss_fn(GAMMA, ITERS, bidirectional=True)
    g = torch.Generator().manual_seed(SEED_PERTURB)
    grads = []
    for eps in (0.0, PERTURB):
        m = copy.deepcopy(model)
        with torch.no_grad():
            for p in m.parameters():
                p.mul_(1 + eps * torch.randn(p.shape, generator=g))
        loss, _ = loss_fn(m, batch)
        loss.backward()
        grads.append(to_jax({n: p.grad for n, p in m.named_parameters()},
                            cfg=m.cfg))
    return {k: float(np.linalg.norm(grads[1][k] - g0)
                     / max(np.linalg.norm(g0), 1e-30))
            for k, g0 in grads[0].items()}


def test_bidirectional_step_loss_and_metrics_match_jax(one_step):
    _, _, jmet, _, met, _ = one_step
    for k in ("loss", "grad_norm", "epe", "epe_bw", "1px", "3px", "5px"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(met["grad_norm"]) > 1.0        # clipping is active


def test_bidirectional_step_gradients_match_jax(one_step):
    _, jstate, _, tm, _, sens = one_step
    want = _flatten(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, _mu(jstate.opt_state))["params"])
    got = to_jax({n: p.grad for n, p in tm.named_parameters()}, cfg=tm.cfg)
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    noise = [p for p in got if NOISE.fullmatch(p)]
    assert len(noise) == (30 if tm.cfg.encoder == "basic" else 0)
    for path, g in got.items():
        w = want[path]
        if path in noise:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * top, path
            continue
        if sens.get(path, 0.0) > SENSITIVE:
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= 1e-4 + PERTURB_SLACK * sens[path], (
                path, err, sens[path])
            continue
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-12),
                                   err_msg=path)


def test_bidirectional_step_params_and_stats_match_jax(one_step):
    """Each updated parameter within 1e-2 lr of JAX's, plus what the two
    sides' gradient difference makes of AdamW's first step, lr g / (|g| +
    eps): at most lr |dg| eps / (min |g| + eps)^2 an element (a few
    elements of the cnet's ill-conditioned leaves lie near |g| ~ eps)."""
    v, jstate, _, tm, _, _ = one_step
    got = to_jax_variables(tm.state_dict(), cfg=tm.cfg)
    want = _flatten(jax.tree_util.tree_map(np.asarray,
                                           jstate.params["params"]))
    g_port = to_jax({n: p.grad for n, p in tm.named_parameters()},
                    cfg=tm.cfg)
    g_jax = _flatten(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, _mu(jstate.opt_state))["params"])
    before = _flatten(v["params"])
    assert set(got["params"]) == set(want)
    for path, p in got["params"].items():
        if NOISE.fullmatch(path):
            for q in (p, want[path]):
                assert np.abs(q - before[path]).max() < 0.1 * LR, path
            continue
        gp, gj = g_port[path], g_jax[path]
        slack = LR * np.abs(gp - gj) * EPS / (
            np.minimum(np.abs(gp), np.abs(gj)) + EPS) ** 2
        assert (np.abs(p - want[path]) <= 1e-2 * LR + slack).all(), path
        assert not np.array_equal(p, before[path]), f"{path} did not move"
    bn = "batch_stats" in v
    assert set(got) == ({"params", "batch_stats"} if bn else {"params"})
    if bn:
        want_s = _flatten(jax.tree_util.tree_map(
            np.asarray, jstate.model_state["batch_stats"]))
        before_s = _flatten(v["batch_stats"])
        assert set(got["batch_stats"]) == set(want_s) and len(want_s) == 30
        for path, s in got["batch_stats"].items():
            np.testing.assert_allclose(s, want_s[path], rtol=1e-5,
                                       atol=1e-5, err_msg=path)
            assert not np.array_equal(s, before_s[path]), path


# ------------------------------------------------------------------ (b)
def _bn_model(seed=3, remat=False, t=T):
    cfg = StreamFlowConfig(T=t, iters=1, mixed_precision=False,
                           encoder="basic", remat=remat)
    model = create_model("streamflow", cfg=cfg, device="cpu", train=True)
    init_weights(model, seed)
    return model


def _stats_of(model):
    return [s.clone() for s in batch_stats(model)]


def test_bidirectional_batchnorm_keeps_the_reversed_clips_update():
    """JAX starts both applications from the same pre-step statistics and
    keeps the second's update (training/step.py:66-75, 104-115): the
    statistics after the step equal one train-mode forward of the
    reversed clip alone from the pre-step statistics, and differ from the
    forward clip's update."""
    batch = _torch(_batch(8, h=32, w=48))
    model = _bn_model()
    ref_rev, ref_fwd = copy.deepcopy(model), copy.deepcopy(model)
    make_loss_fn(GAMMA, 1, bidirectional=True)(model, batch)
    with torch.no_grad():
        ref_rev(batch["images"].flip(1), iters=1, train=True)
        ref_fwd(batch["images"], iters=1, train=True)
    got, rev, fwd = map(_stats_of, (model, ref_rev, ref_fwd))
    assert len(got) == 30
    for g, r, f in zip(got, rev, fwd):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6)
        assert not torch.equal(g, f)


def test_one_application_one_update_and_remat_runs_batchnorm_once():
    """Without ``bidirectional`` a step's forward updates the statistics
    once; with remat the encoders are not recomputed in the backward (each
    BatchNorm runs once, and the statistics equal those without remat);
    ``train=False`` uses and keeps them."""
    batch = _torch(_batch(9, h=32, w=48))
    calls = []
    outs = {}
    for remat in (False, True):
        model = _bn_model(remat=remat)
        hooks = [m.register_forward_hook(lambda *a: calls.append(remat))
                 for m in model.modules() if isinstance(m, BatchNorm)]
        s0 = _stats_of(model)
        loss, _ = make_loss_fn(GAMMA, 2)(model, batch)
        loss.backward()
        outs[remat] = _stats_of(model)
        assert calls.count(remat) == 15, calls.count(remat)
        for h in hooks:
            h.remove()
        assert all(not torch.equal(a, b) for a, b in zip(s0, outs[remat]))
        with torch.no_grad():
            model(batch["images"], iters=1, test_mode=True)
            model(batch["images"], iters=1)
        assert all(torch.equal(a, b) for a, b in
                   zip(_stats_of(model), outs[remat]))
    for a, b in zip(outs[False], outs[True]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------------ (c)
def test_checkpoint_resumes_batchnorm_state_exactly(tmp_path):
    """Two steps straight equal one step, a checkpoint, a restore into a
    fresh state, and one step: parameters, AdamW state and running
    statistics bit for bit."""
    batches = [_torch(_batch(s, h=32, w=48)) for s in (10, 11)]
    step = make_train_step(GAMMA, 1, bidirectional=True)

    def fresh(seed):
        return TrainState.create(_bn_model(seed), lr=1e-3, num_steps=10)

    straight = fresh(3)
    for b in batches:
        step(straight, b)
    first = fresh(3)
    step(first, batches[0])
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(first, wait=True)
    resumed = mgr.restore(fresh(4))
    assert all(torch.equal(a, b) for a, b in zip(_stats_of(resumed.model),
                                                 _stats_of(first.model)))
    step(resumed, batches[1])
    sa, sb = resumed.state_dict(), straight.state_dict()
    assert sa["model"].keys() == sb["model"].keys()
    assert any(k.endswith("running_var") for k in sa["model"])
    for k, t in sa["model"].items():
        assert torch.equal(t, sb["model"][k]), k
    for i, st in sa["optimizer"]["state"].items():
        for k, t in st.items():
            assert torch.equal(t, sb["optimizer"]["state"][i][k]), (i, k)
    assert resumed.step == straight.step == 2


def test_jax_variables_npz_with_batch_stats_loads(tmp_path):
    """An npz of JAX variables ({'params', 'batch_stats'}, the layout of
    JAX's checkpoint.save_params_npz over a variables dict) loads into the
    port with its running statistics; the port writes the same file."""
    cfg = dict(T=T, iters=ITERS, mixed_precision=False, encoder="res18_3d")
    v = _variables(jax_create("streamflow", cfg=JaxConfig(**cfg)), seed=7)
    path = str(tmp_path / "v.npz")
    jckpt.save_params_npz(path, v)
    tm = create_model("streamflow", cfg=StreamFlowConfig(**cfg),
                      device="cpu")
    load_jax(tm, checkpoint.load_variables_npz(path))
    back = to_jax_variables(tm.state_dict(), cfg=tm.cfg)
    for coll in ("params", "batch_stats"):
        want = _flatten(v[coll])
        assert set(back[coll]) == set(want)
        assert all(np.array_equal(back[coll][k], want[k]) for k in want)
    out = str(tmp_path / "port.npz")
    checkpoint.save_params_npz(out, back)
    reread = jckpt.load_variables_npz(out)
    assert set(reread) == {"params", "batch_stats"}
    assert np.array_equal(
        reread["batch_stats"]["cnet"]["layer3_1"]["spatial"]["norm2"][
            "BatchNorm_0"]["var"],
        v["batch_stats"]["cnet"]["layer3_1"]["spatial"]["norm2"][
            "BatchNorm_0"]["var"])


def test_graphed_forward_runs_batchnorm_on_running_stats():
    """An eval model with BatchNorm through GraphedForward (eager on the
    CPU) and the validators' window step: the test-mode forward bit for
    bit, the running statistics untouched (unit statistics moved first so
    that eval mode differs from train mode)."""
    train = _bn_model(seed=12)
    with torch.no_grad():    # statistics away from (0, 1)
        train(torch.from_numpy(_batch(12, h=32, w=48)["images"]), iters=1,
              train=True)
    model = create_model("streamflow", cfg=train.cfg, device="cpu")
    model.load_state_dict(train.state_dict())
    s0 = _stats_of(model)
    imgs = _batch(13, h=32, w=48)["images"]
    fwd = GraphedForward(model, 1)
    got = fwd(torch.from_numpy(imgs))
    want = model(torch.from_numpy(imgs), iters=1, test_mode=True)
    assert torch.equal(got, want)
    win = window_flows(fwd, imgs[0], "cpu")
    assert np.array_equal(win, want[0].numpy())
    assert all(torch.equal(a, b) for a, b in zip(_stats_of(model), s0))
    batch_mode = model(torch.from_numpy(imgs), iters=1, test_mode=True,
                       train=True)
    assert not torch.equal(batch_mode, want)
