"""The port's trainer CLI (streamflow_tpu_torch/tools/train.py) against the
JAX package's tools/train.py, and the port's eval_all_ckpts, on the CPU
at a tiny size (64x96, 1 iteration, f32) over the synthetic FlyingThings
(TRAIN) and Sintel trees of tests/_torch_serving.py:

- PRESETS and every flag default equal the JAX CLI's (its three
  multi-host flags included), but for the port's ``--device``; a preset
  fills the flags not given, in both;
- a 2-step run with ``--validation sintel`` writes metrics.jsonl, ckpts/
  and best.npz, whose paths and shapes are the JAX model's param tree;
  a second run with a larger ``--num_steps`` resumes from the saved step;
  eval_all_ckpts ranks the run's checkpoints;
- no new module of the port, nor what chip_smoke.py imports, loads jax,
  the JAX package, PIL or cv2 (in a subprocess).
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_serving import sintel_tree, things_tree

from streamflow_tpu.config import StreamFlowConfig as JaxConfig
from streamflow_tpu.models import create_model as jax_create
from streamflow_tpu.training.checkpoint import load_params_npz
from streamflow_tpu_torch.tools import eval_all_ckpts
from streamflow_tpu_torch.tools import train as port_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(4)
PORT_ONLY = {"device"}


@pytest.fixture(scope="module")
def jax_train():
    """The JAX package's tools/train.py, loaded by path (it imports only
    numpy at the top)."""
    spec = importlib.util.spec_from_file_location(
        "jax_tools_train", os.path.join(ROOT, "tools", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [[], ["--preset", "things", "--lr", "1e-4"],
                                  ["--preset", "sintel_kitti",
                                   "--batch_size", "2", "--T", "3"],
                                  ["--preset", "bithings"]])
def test_presets_and_flags_match_the_jax_cli(jax_train, monkeypatch, argv):
    assert port_train.PRESETS == jax_train.PRESETS
    assert port_train.VAL_KEY == jax_train.VAL_KEY
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    want = vars(jax_train.parse_args())
    got = vars(port_train.parse_args(argv))
    assert set(want) <= set(got)
    assert set(got) - set(want) == PORT_ONLY and got["device"] == "cuda"
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])


def test_a_flag_given_as_name_equals_value_overrides_the_preset():
    """(The JAX CLI looks for the flag's name alone in sys.argv and lets
    the preset overwrite ``--batch_size=2``.)"""
    args = port_train.parse_args(["--preset", "sintel_kitti",
                                  "--batch_size=2"])
    assert args.batch_size == 2 and args.lr == 1.75e-4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two runs of the CLI in one output directory: 2 steps, then 3 (a
    resume), each validating and checkpointing every step."""
    base = tmp_path_factory.mktemp("train_cli")
    things = things_tree(base / "things", split="TRAIN")
    sintel = sintel_tree(base / "sintel")
    argv = ["--preset", "things", "--image_size", "64", "96",
            "--batch_size", "2", "--iters", "1", "--val_iters", "1",
            "--val_freq", "1", "--print_freq", "1", "--no_mixed_precision",
            "--device", "cpu", "--num_workers", "2", "--things_root", things,
            "--sintel_root", sintel, "--output", str(base / "out")]
    first = port_train.main(argv + ["--num_steps", "2"])
    out = base / "out" / "streamflow"
    files = sorted(os.listdir(out)), sorted(os.listdir(out / "ckpts"))
    metrics = (out / "metrics.jsonl").read_text()
    best = load_params_npz(str(out / "best.npz"))
    second = port_train.main(argv + ["--num_steps", "3"])
    return dict(base=base, out=out, first=first, second=second, files=files,
                metrics=metrics, best=best, sintel=sintel)


def test_a_run_writes_metrics_checkpoints_and_best(run):
    files, ckpts = run["files"]
    assert {"metrics.jsonl", "ckpts", "best.npz", "log.txt"} <= set(files)
    assert ckpts == ["step_1.pt", "step_2.pt"]
    records = [json.loads(ln) for ln in run["metrics"].splitlines()]
    assert [r["step"] for r in records] == [1, 1, 2, 2]
    assert set(records[0]) == {"step", "lr", "loss", "epe", "1px", "3px",
                               "5px", "grad_norm"}
    assert set(records[1]["val"]) == {"clean_epe", "clean_1px", "clean_3px",
                                      "clean_5px"}
    assert run["first"].state.step == 2
    assert run["first"].best_val == min(r["val"]["clean_epe"]
                                        for r in records if "val" in r)


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_shapes(v, p) if hasattr(v, "items")
                   else {p: tuple(v.shape)})
    return out


def test_best_npz_is_the_jax_models_param_tree(run):
    jm = jax_create("streamflow", cfg=JaxConfig(T=3, iters=1,
                                                mixed_precision=False))
    tree = jax.eval_shape(
        lambda k, x: jm.init(k, x, test_mode=True), jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 3, 64, 96, 3), jnp.float32))["params"]
    assert _shapes(run["best"]) == _shapes(tree)
    assert all(v.dtype == np.float32 for v in jax.tree_util.tree_leaves(
        run["best"]))


def test_a_second_run_resumes_from_the_saved_step(run):
    out = run["out"]
    assert "resumed from step 2" in (out / "log.txt").read_text()
    assert run["second"].state.step == 3
    assert sorted(os.listdir(out / "ckpts")) == ["step_1.pt", "step_2.pt",
                                                 "step_3.pt"]
    records = [json.loads(ln) for ln in
               (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 1, 2, 2, 3, 3]


def test_eval_all_ckpts_ranks_the_runs_checkpoints(run, capsys):
    res = eval_all_ckpts.main([
        "--ckpt_dir", str(run["out"] / "ckpts"), "--dataset", "sintel",
        "--T", "3", "--iters", "1", "--device", "cpu",
        "--sintel_root", run["sintel"]])
    assert sorted(res["all"]) == ["1", "2", "3"]
    assert res["metric"] == "clean_epe"
    epes = {int(s): r["clean_epe"] for s, r in res["all"].items()}
    assert all(np.isfinite(v) for v in epes.values())
    assert res["best_step"] == min(epes, key=epes.get)
    assert res["value"] == epes[res["best_step"]]
    lines = capsys.readouterr().out.splitlines()
    assert json.loads("\n".join(lines[lines.index("{"):])) == res


def _is_module(name):
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:   # an attribute of a module
        return False


def _chip_smoke_imports():
    """The port's modules that chip_smoke.py imports (in its functions
    too): ``import a.b`` and ``from a import b`` with b a module."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names
                         if _is_module(f"{node.module}.{a.name}"))
    return sorted(n for n in names if n.startswith("streamflow_tpu_torch"))


def test_the_trainer_and_chip_smoke_load_no_jax_pil_or_cv2():
    mods = ["streamflow_tpu_torch.utils.logger",
            "streamflow_tpu_torch.data.loader",
            "streamflow_tpu_torch.training.optim",
            "streamflow_tpu_torch.training.state",
            "streamflow_tpu_torch.training.step",
            "streamflow_tpu_torch.training.checkpoint",
            "streamflow_tpu_torch.params",
            "streamflow_tpu_torch.tools.train",
            "streamflow_tpu_torch.tools.eval_all_ckpts"]
    smoke = _chip_smoke_imports()
    assert "streamflow_tpu_torch.tools.train" in smoke
    code = "\n".join(["import sys", *(f"import {m}" for m in mods + smoke),
                      "bad = [m for m in sys.modules if m.split('.')[0] in "
                      "('jax', 'jaxlib', 'flax', 'streamflow_tpu', 'PIL', "
                      "'cv2')]",
                      "assert not bad, bad"])
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
