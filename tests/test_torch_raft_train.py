"""The port's two-frame training against the JAX package's, on the CPU in
f32, with seeded numpy inputs and the same random weights and running
statistics (through the bridge), and the ``train_2f`` CLI.

(a) One ``make_train_step_2f`` step of RAFT and of SKFlow (GMA) at B=2,
    64x96, iters=2, at ``tools/train_2f.py``'s defaults (gamma 0.8, lr
    4e-4, weight decay 1e-4, clip 1.0), against JAX's
    ``make_train_step_2f`` (training/step.py:127-164): one application on
    the pair, so the running statistics after the step are one momentum
    update from this batch (1e-5). Loss, metrics and the gradients' norm
    1e-4 relative; each clipped gradient (JAX's from its Adam first
    moment) 1e-4 of its leaf's largest element; each updated parameter
    1e-2 of lr plus AdamW's first-step sensitivity to the gradient
    difference (tests/test_torch_zoo_train.py's bounds and reasons). A
    conv bias that feeds a norm (the fnet's instance norm, the cnet's
    BatchNorm on batch statistics) has a gradient of zero in exact
    arithmetic: both sides' are rounding noise, held to 1e-6 of the
    largest gradient element, and each moves by less than lr / 10. The
    encoders' gradients through the norms' statistics (the cnet's
    BatchNorm on batch statistics, the fnet's instance norm) are sums that
    cancel, and SKFlow's ~1e3 px random-weight flows amplify the rest: a
    leaf whose gradient moves by more than 1e-4 (relative L2) when every
    weight moves by a relative 1e-5 is held to a relative L2 error of 1e-4
    + 4 times that move, as chip_smoke.py's training guard holds every
    leaf (tests/test_torch_zoo_train.py); the two packages differ there by
    at most ~1e-5 (relative L2) on these weights.
(b) ``tools/train_2f.py`` on a synthetic FlyingChairs tree: a second run
    resumes from the first's checkpoint exactly (its step equals one taken
    in memory from the first run's live state, bit for bit: parameters,
    AdamW state, running statistics); ``--restore_ckpt`` restores the
    parameters only.
"""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_raft import H, ITERS, W, jax_raft, port_raft
from _torch_serving import chairs_tree
from streamflow_tpu.training import optim as JO
from streamflow_tpu.training.state import TrainState as JState
from streamflow_tpu.training.step import make_train_step_2f as j_make_step
from streamflow_tpu_torch.params import _flatten, to_jax, to_jax_variables
from streamflow_tpu_torch.training import checkpoint
from streamflow_tpu_torch.training.state import TrainState
from streamflow_tpu_torch.training.step import (batch_stats,
                                                make_loss_fn_2f,
                                                make_train_step_2f)

torch.set_num_threads(2)
LR, WD, GAMMA, B = 4e-4, 1e-4, 0.8, 2
# conv biases followed by a norm that removes them (flax paths)
NOISE = re.compile(r"(fnet|cnet)/(conv1|layer\d_\d/(conv1|conv2|"
                   r"downsample))/bias")
PERTURB, SENSITIVE, PERTURB_SLACK = 1e-5, 1e-4, 4.0
EPS = 1e-8              # AdamW's epsilon (both packages' default)


def _batch(seed, b=B, h=H, w=W):
    rng = np.random.default_rng(seed)
    return {"images": rng.integers(0, 255, (b, 2, h, w, 3)).astype(
                np.float32),
            "flows": (4.0 * rng.standard_normal((b, 1, h, w, 2))).astype(
                np.float32),
            "valids": (rng.random((b, 1, h, w)) > 0.1).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _mu(opt_state):
    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(node, "mu"):
            return node.mu
    raise AssertionError("no Adam state")


def _sensitivity(model, batch):
    """Per flax path, the relative L2 change of the port's gradient when
    every weight moves by a relative PERTURB, from copies of ``model``."""
    loss_fn = make_loss_fn_2f(GAMMA, ITERS)
    g = torch.Generator().manual_seed(2)
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


@pytest.fixture(scope="module", params=[("raft", False), ("sk", True)],
                ids=["raft", "skflow"])
def one_step(request):
    """One step of each package from the same weights, statistics and
    batch: (variables, JAX state, JAX metrics, port model, port metrics,
    sensitivities)."""
    ub, gma = request.param
    jm, v = jax_raft(ub, gma)
    batch = _batch(5)
    tx = JO.make_optimizer(LR, 100, WD)
    jstep = jax.jit(j_make_step(jm, tx, gamma=GAMMA, iters=ITERS))
    jstate = JState.create({"params": v["params"]}, tx,
                           model_state={"batch_stats": v["batch_stats"]})
    jstate, jmet = jstep(jstate, {k: jnp.asarray(a)
                                  for k, a in batch.items()})
    tm = port_raft(ub, gma, v, train=True)
    sens = _sensitivity(tm, _torch(batch))
    state = TrainState.create(tm, lr=LR, num_steps=100, weight_decay=WD)
    met = make_train_step_2f(GAMMA, ITERS)(state, _torch(batch))
    return v, jstate, jmet, tm, met, sens


def test_step_loss_and_metrics_match_jax(one_step):
    _, _, jmet, _, met, _ = one_step
    assert set(met) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(met["grad_norm"]) > 1.0        # clipping is active


def test_step_gradients_match_jax(one_step):
    _, jstate, _, tm, _, sens = one_step
    want = _flatten(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, _mu(jstate.opt_state))["params"])
    got = to_jax({n: p.grad for n, p in tm.named_parameters()}, cfg=tm.cfg)
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    noise = [p for p in got if NOISE.fullmatch(p)]
    assert len(noise) == 30
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


def test_step_params_and_stats_match_jax(one_step):
    """Each updated parameter within 1e-2 lr of JAX's, plus what the two
    sides' gradient difference makes of AdamW's first step; the running
    statistics one momentum update from this batch, as JAX's."""
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
    want_s = _flatten(jax.tree_util.tree_map(
        np.asarray, jstate.model_state["batch_stats"]))
    before_s = _flatten(v["batch_stats"])
    assert set(got["batch_stats"]) == set(want_s) and len(want_s) == 30
    for path, s in got["batch_stats"].items():
        np.testing.assert_allclose(s, want_s[path], rtol=1e-5, atol=1e-5,
                                   err_msg=path)
        assert not np.array_equal(s, before_s[path]), path


# ------------------------------------------------------------------ (b)
def _cli(root, out, steps, *extra):
    from streamflow_tpu_torch.tools import train_2f

    return train_2f.main([
        "--model", "sk", "--stage", "chairs", "--chairs_root", root,
        "--output", str(out), "--num_steps", str(steps), "--batch_size",
        "2", "--image_size", "32", "48", "--iters", "1", "--val_freq", "1",
        "--print_freq", "1", "--num_workers", "2", "--no_mixed_precision",
        "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def chairs(tmp_path_factory):
    return chairs_tree(tmp_path_factory.mktemp("raft_train") / "chairs")


def test_train_2f_resumes_exactly(chairs, tmp_path, capsys):
    """One step, then a second run to step 2 in the same directory: it
    resumes from the checkpoint and, as JAX's CLI, starts the loader again
    at epoch 0. Its final state (parameters, AdamW state, schedule,
    running statistics) equals, bit for bit, one more step taken in
    memory from the first run's live state on the loader's first batch;
    metrics are logged every step."""
    from streamflow_tpu_torch.data.datasets import fetch_dataset_2f
    from streamflow_tpu_torch.data.loader import DataLoader

    first = _cli(chairs, tmp_path, 1).state
    assert first.step == 1
    ref = copy.deepcopy(first)
    resumed = _cli(chairs, tmp_path, 2).state
    assert "resumed from step 1" in capsys.readouterr().out
    loader = DataLoader(fetch_dataset_2f("chairs", image_size=(32, 48),
                                         chairs_root=chairs), 2,
                        num_workers=2, seed=1234)
    batch = next(iter(loader.epoch(0)))
    assert batch["images"].shape == (2, 2, 32, 48, 3)
    make_train_step_2f(GAMMA, 1)(ref, _torch(batch))
    sa, sb = resumed.state_dict(), ref.state_dict()
    assert resumed.step == ref.step == 2
    assert any(k.endswith("running_var") for k in sa["model"])
    for k, t in sa["model"].items():
        assert torch.equal(t, sb["model"][k]), k
    for i, st in sa["optimizer"]["state"].items():
        for k, t in st.items():
            assert torch.equal(t, sb["optimizer"]["state"][i][k]), (i, k)
    assert resumed.lr == ref.lr
    ckpts = checkpoint.CheckpointManager(str(tmp_path / "raft" / "ckpts"))
    assert ckpts.all_steps() == [1, 2]
    lines = (tmp_path / "raft" / "metrics.jsonl").read_text()
    assert lines.count("\n") == 2 and "epe" in lines


def test_train_2f_restores_params_only(chairs, tmp_path):
    """``--restore_ckpt``: an npz of flax variables (params and
    batch_stats) starts the parameters; the running statistics keep their
    start (unit variance, zero mean), as JAX's CLI restores params only."""
    _, v = jax_raft("sk", True)
    path = str(tmp_path / "v.npz")
    checkpoint.save_params_npz(path, v)
    run = _cli(chairs, tmp_path / "c", 0, "--restore_ckpt", path)
    model = run.state.model
    got = to_jax_variables(model.state_dict(), cfg=model.cfg)
    want = _flatten(v["params"])
    assert all(np.array_equal(got["params"][k], want[k]) for k in want)
    stats = batch_stats(model)
    assert len(stats) == 30
    assert all(bool((s == 0).all()) or bool((s == 1).all()) for s in stats)
