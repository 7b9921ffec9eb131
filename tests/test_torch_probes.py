"""The trained-dynamics probes of the port (streamflow_tpu_torch/tools/
probe_bf16.py and probe_guard.py) against the JAX package's tools, on the
CPU at a small size.

(a) The probe's training loop (``probe_bf16.train``: AdamW + OneCycle at
    lr 2.5e-4 over steps + 100, gamma 0.85, ``synth_batch(1..steps)``) at
    64x96, T=4, iters 2, f32, 2 steps, against JAX's ``make_train_step``
    and ``make_optimizer(lr=2.5e-4, num_steps=102)`` on the same batches,
    from the same weights (JAX's own ``model.init``, as its probe starts,
    moved through ``params.from_jax``). tests/test_torch_train.py's
    tolerances: loss and metrics 1e-4 relative; a parameter within 1e-2
    of lr for each update (its one-step bound: Adam's lr g / (|g| + eps)
    carries its gradient's relative error, largest where |g| is tiny), so
    2e-2 of lr after the two.
(b) ``synth_batch`` reproduces JAX's formula bit for bit: the closure of
    tools/probe_bf16.py itself, taken from its source, for two seeds.
(c) On the CPU both tools' reports are wired: the "kernel" paths are the
    plain path (EPE exactly 0), bf16 differs, control A is non-zero, the
    JSON records carry their keys, the results files get the lines, the
    saved best.npz loads into a model through ``load_variables_npz`` and
    ``load_jax``; the per-iteration flows that probe_guard reads equal a
    k-iteration test-mode forward bit for bit.
"""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamflow_tpu.config import StreamFlowConfig as JaxConfig
from streamflow_tpu.models import create_model as jax_create
from streamflow_tpu.training import optim as JO
from streamflow_tpu.training.state import TrainState as JState
from streamflow_tpu.training.step import make_train_step as j_make_step
from streamflow_tpu_torch.config import StreamFlowConfig
from streamflow_tpu_torch.models import create_model
from streamflow_tpu_torch.params import _flatten, load_jax, to_jax
from streamflow_tpu_torch.tools import probe_bf16 as PB
from streamflow_tpu_torch.tools import probe_guard as PG

torch.set_num_threads(4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, H, W, ITERS, STEPS = 4, 64, 96, 2, 2


def _jax_synth_batch(h, w, t):
    """JAX's ``synth_batch`` closure (tools/probe_bf16.py:66-82), compiled
    from that file's own source with its free names bound."""
    with open(os.path.join(ROOT, "tools", "probe_bf16.py")) as fh:
        tree = ast.parse(fh.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "synth_batch")
    ns = {"np": np, "jnp": jnp, "H": h, "W": w, "T": t}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "probe_bf16.py",
                 "exec"), ns)
    return ns["synth_batch"]


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("seed", [1, 7])
def test_synth_batch_is_jax_bit_for_bit(seed):
    want = _jax_synth_batch(H, W, T)(seed)
    got = PB.synth_batch(seed, T, H, W)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_synth_batch_refuses_sizes_off_its_32_px_blocks():
    with pytest.raises(ValueError, match="divisible by 32"):
        PB.synth_batch(1, T, 72, 96)


# ------------------------------------------------------------------ (a)
@pytest.fixture(scope="module")
def trained_pair():
    """STEPS steps of JAX's probe loop and of the port's, f32, from JAX's
    own initialisation of the model."""
    jm = jax_create("streamflow", cfg=JaxConfig(
        T=T, iters=ITERS, mixed_precision=False, remat=True, scan_unroll=1))
    synth = _jax_synth_batch(H, W, T)
    params = jax.jit(lambda k, x: jm.init(k, x, iters=1))(
        jax.random.PRNGKey(0), synth(0)["images"])
    tx = JO.make_optimizer(lr=PB.LR, num_steps=STEPS + 100)
    jstate = JState.create(params, tx)
    jstep = jax.jit(j_make_step(jm, tx, gamma=PB.GAMMA, iters=ITERS))
    for i in range(STEPS):
        jstate, jmet = jstep(jstate, synth(i + 1))

    tm = create_model("streamflow", cfg=StreamFlowConfig(
        T=T, iters=ITERS, mixed_precision=False, remat=True), device="cpu",
        train=True)
    load_jax(tm, params)
    lines = []
    state, met = PB.train(tm, STEPS, T, H, W, ITERS, log=lines.append,
                          print_every=1)
    return params, jstate, jmet, state, met, lines


def test_probe_training_loss_and_metrics_match_jax(trained_pair):
    _, _, jmet, state, met, lines = trained_pair
    assert state.step == STEPS and len(lines) == STEPS
    assert lines[0].startswith("step    0: loss=")
    for k in ("loss", "grad_norm", "epe", "1px", "3px", "5px"):
        np.testing.assert_allclose(met[k], float(jmet[k]), rtol=1e-4,
                                   err_msg=k)


def test_probe_training_parameters_match_jax(trained_pair):
    params, jstate, _, state, _, _ = trained_pair
    want = _flatten(jax.tree_util.tree_map(np.asarray,
                                           jstate.params["params"]))
    before = _flatten(params["params"])
    got = to_jax(state.model.state_dict())
    assert set(got) == set(want)
    for path, p in got.items():
        np.testing.assert_allclose(p, want[path], rtol=0,
                                   atol=STEPS * 1e-2 * PB.LR, err_msg=path)
    # the leaves that moved: the same in both (a zero-initialised leaf
    # whose gradient is 0 stays where it is in both)
    moved = {path for path, p in got.items()
             if not np.array_equal(p, np.asarray(before[path]))}
    assert moved == {path for path, p in want.items()
                     if not np.array_equal(p, np.asarray(before[path]))}
    assert len(moved) > 0.9 * len(got)


# ------------------------------------------------------------------ (c)
@pytest.fixture(scope="module")
def probe_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("probe")
    rec = PB.main(["--steps", "1", "--height", "64", "--width", "96",
                   "--eval_height", "60", "--eval_width", "90", "--iters",
                   "2", "--device", "cpu", "--out", str(out), "--results",
                   str(out / "probe_bf16.txt")])
    return out, rec


def test_probe_bf16_report_on_the_cpu(probe_run):
    out, rec = probe_run
    for key in ("steps", "train", "eval", "padded", "T", "iters", "device",
                "last_loss", "last_epe", "ms_per_step", "flow_ref_mean",
                "flow_ref_max", "f32_kernels", "bf16_kernels", "phases_s",
                "ckpt"):
        assert key in rec, key
    assert rec["device"] == "cpu" and rec["padded"] == [64, 96]
    assert rec["f32_kernels"] == {"epe_mean": 0.0, "epe_p99": 0.0,
                                  "epe_max": 0.0}
    assert 0 < rec["bf16_kernels"]["epe_max"] < rec["flow_ref_max"]
    assert set(rec["bf16_kernels"]) == {"epe_mean", "epe_p99", "epe_max"}
    lines = (out / "probe_bf16.txt").read_text().splitlines()
    assert lines[0].startswith("probe_bf16: 1 steps at 64x96")
    assert "f32 kernels vs f32 plain: EPE mean 0.0000 px" in lines[1]
    assert json.loads(lines[-1]) == json.loads(json.dumps(rec))


def test_probe_bf16_weights_load_into_a_serving_model(probe_run):
    from streamflow_tpu_torch.training.checkpoint import load_variables_npz

    _, rec = probe_run
    model = create_model("streamflow", cfg=StreamFlowConfig(
        T=T, iters=2, mixed_precision=False), device="cpu")
    load_jax(model, load_variables_npz(rec["ckpt"]))
    flows = model(PB.eval_clip(T, 60, 90), test_mode=True)
    assert flows.shape == (1, T - 1, 64, 96, 2)
    assert float(flows.norm(dim=-1).max()) == pytest.approx(
        rec["flow_ref_max"], rel=1e-6)


def test_probe_guard_report_on_the_cpu(probe_run, tmp_path):
    _, rec = probe_run
    res = PG.main(["--height", "64", "--width", "96", "--device", "cpu",
                   "--ckpt", rec["ckpt"], "--results",
                   str(tmp_path / "g.txt")])
    assert set(res) >= {"size", "padded", "eps", "device", "ckpt",
                        "random", "trained", "phases_s"}
    for weights in ("random", "trained"):
        a, b = res[weights]["A"], res[weights]["B"]
        assert set(a) == {"2", "12"} and set(b) == {"1", "2", "4", "8",
                                                    "12"}
        for s in b.values():
            assert s["max_epe"] == 0.0 and s["a_max"] == s["b_max"] > 0
        for s in a.values():
            assert 0 < s["max_epe"] < 1e-2 and s["rel_epe"] > 0
    lines = (tmp_path / "g.txt").read_text().splitlines()
    assert "A. input-perturbation control" in lines[2]
    assert json.loads(lines[-1])["trained"] == res["trained"]


def test_per_iteration_flows_are_test_mode_flows():
    plain, _ = PG.models(None, "cpu", 3)
    clip = PB.eval_clip(T, 60, 90)
    per = PG.iter_flows(plain, clip, 3)
    for k in (1, 2, 3):
        assert torch.equal(per[k - 1], plain(clip, iters=k, test_mode=True))
