"""The two-frame baselines' validators and tools in the port against the
JAX package's, on the CPU in f32 at a tiny size, with the same random
weights, on synthetic dataset trees (tests/_torch_serving.py):

- ``validate_chairs`` (unpadded), ``validate_things`` (clean and final,
  'sintel' padding) and ``validate_sintel_2f`` (clean and final, 'sintel'
  padding, a 60x90 tree padded to 64x96) through ``GraphedForward2F``
  against JAX's through ``JittedForward2F``: the same keys, EPE rtol 1e-4
  (test_torch_serving_eval.py's bound for the multi-frame validators);
- ``tools/evaluate.py --model gma`` on the chairs and things trees
  against JAX's validators, and its ValueError for a multi-frame dataset;
- ``tools/convert.py`` on synthetic reference ``.pth`` files (a
  DataParallel ``module.`` prefix under a 'model' key) writes the npz
  that JAX's CLI writes, array for array and bit for bit, for
  ``--model streamflow`` and ``sk``, strict and ``--lenient``; the npz
  loads into the port as the weights it came from;
- no new module loads jax or the JAX package (in a subprocess).
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_raft import ITERS, jax_raft, port_raft, shared_jax_forward_2f
from _torch_serving import chairs_tree, sintel_tree, things_tree
from streamflow_tpu import evaluation as jev
from streamflow_tpu.training import checkpoint as jckpt
from streamflow_tpu_torch import evaluation
from streamflow_tpu_torch.models import create_model
from streamflow_tpu_torch.params import load_jax
from streamflow_tpu_torch.tools.common import init_weights

ROOT = Path(__file__).resolve().parent.parent
torch.set_num_threads(4)


@pytest.fixture(scope="module", autouse=True)
def _one_jax_forward():
    with shared_jax_forward_2f():
        yield


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("raft_tools")
    return {"chairs": chairs_tree(base / "chairs"),
            "things": things_tree(base / "things"),
            "sintel": sintel_tree(base / "sintel", h=60, w=90)}


@pytest.fixture(scope="module")
def gma():
    """RAFT-GMA of both packages with the same weights: (JAX model, its
    variables, the port's model)."""
    jm, v = jax_raft("gma", True)
    return jm, v, port_raft("gma", True, v)


def _close(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", ["chairs", "things", "sintel_2f"])
def test_validators_match_jax(trees, gma, name, capsys):
    jm, v, tm = gma
    fn, root = {"chairs": ("validate_chairs", trees["chairs"]),
                "things": ("validate_things", trees["things"]),
                "sintel_2f": ("validate_sintel_2f", trees["sintel"])}[name]
    fwd = evaluation.GraphedForward2F(tm, ITERS)
    got = getattr(evaluation, fn)(fwd, root, iters=ITERS)
    want = getattr(jev, fn)(jm, v, root, iters=ITERS)
    _close(got, want)
    assert len(fwd.buckets) == 1 and all(
        k[0][2:4] == (64, 96) for k in fwd.buckets)
    out = capsys.readouterr().out
    assert "EPE" in out
    with pytest.raises(ValueError, match="iterations"):
        getattr(evaluation, fn)(fwd, root, iters=ITERS + 1)


def test_graphed_forward_2f_is_the_eager_forward(gma):
    """On the CPU GraphedForward2F runs the model eagerly: the upsampled
    flow of test mode, bit for bit."""
    _, _, tm = gma
    rng = np.random.default_rng(9)
    a, b = (torch.from_numpy(rng.integers(0, 255, (2, 32, 48, 3)).astype(
        np.float32)) for _ in range(2))
    fwd = evaluation.GraphedForward2F(tm, 1)
    assert torch.equal(fwd(a, b), tm(a, b, iters=1, test_mode=True)[1])


@pytest.fixture(scope="module")
def npz(gma, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("raft_ckpt") / "gma.npz")
    jckpt.save_params_npz(path, gma[1])
    return path


@pytest.mark.parametrize("dataset", ["chairs", "things_2f", "things"])
def test_evaluate_tool_matches_jax(trees, gma, npz, dataset, capsys):
    from streamflow_tpu_torch.tools import evaluate

    jm, v, _ = gma
    root = trees["chairs" if dataset == "chairs" else "things"]
    flag = "--chairs_root" if dataset == "chairs" else "--things_root"
    got = evaluate.main(["--model", "gma", "--dataset", dataset,
                         "--device", "cpu", "--fp32", "--ckpt", npz,
                         "--iters", str(ITERS), flag, root])
    assert capsys.readouterr().out.strip().splitlines()[-1] == str(got)
    want = (jev.validate_chairs(jm, v, root, ITERS) if dataset == "chairs"
            else jev.validate_things(jm, v, root, ITERS))
    _close(got, want)


@pytest.mark.parametrize("dataset", ["sintel", "kitti", "spring",
                                     "sintel_occ", "all"])
def test_evaluate_tool_refuses_multi_frame_datasets(dataset):
    """JAX's CLI hands a two-frame model to the multi-frame validators
    (tools/evaluate.py:90-98), which cannot run it; the port raises before
    building anything, naming the two-frame Sintel validator."""
    from streamflow_tpu_torch.tools import evaluate

    for model in ("raft", "gma", "sk"):
        with pytest.raises(ValueError, match="validate_sintel_2f"):
            evaluate.main(["--model", model, "--dataset", dataset,
                           "--device", "cpu"])
    with pytest.raises(ValueError, match="two-frame"):
        evaluate.main(["--dataset", "chairs", "--device", "cpu"])


def _jax_convert():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_convert", ROOT / "tools" / "convert.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pth(path, state_dict, drop=None):
    """A reference-format checkpoint: {'model': {'module.' + key: ...}}."""
    sd = {f"module.{k}": t.detach().clone() for k, t in state_dict.items()
          if k != drop}
    torch.save({"model": sd, "step": 3}, path)
    return str(path)


@pytest.mark.parametrize("model,lenient", [("sk", False), ("sk", True),
                                           ("streamflow", False)])
def test_convert_tool_writes_the_npz_of_jax_cli(tmp_path, monkeypatch,
                                                model, lenient, capsys):
    from streamflow_tpu_torch.tools import convert

    name = "skflow" if model == "sk" else "streamflow"
    src = create_model(name, device="cpu", mixed_precision=False,
                       train=True)
    init_weights(src, 3)
    drop = "update_block.mask.2.weight" if lenient else None
    pth = _pth(tmp_path / "ref.pth", src.state_dict(), drop)
    argv = ["--pth", pth, "--model", model] + (["--lenient"] * lenient)
    out, jout = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    convert.main(argv + ["--out", out])
    monkeypatch.setattr(sys, "argv", ["convert.py", *argv, "--out", jout])
    _jax_convert().main()
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[0].replace(out, "X") == printed[1].replace(jout, "X")
    got, want = np.load(out), np.load(jout)
    assert sorted(got.files) == sorted(want.files)
    assert any(k.startswith("batch_stats/") for k in got.files) == (
        model == "sk")
    for k in want.files:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    if lenient:
        assert "params/step/update_block/mask/conv2/kernel" not in got.files
        with pytest.raises(KeyError, match="mask.2.weight"):
            convert.main(["--pth", pth, "--model", model, "--out", out])
        return
    # the npz carries the weights the .pth came from, into the port
    dst = create_model(name, device="cpu", mixed_precision=False)
    load_jax(dst, jckpt.load_variables_npz(out))
    for k, t in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], t), k


def test_new_modules_load_neither_jax_nor_the_jax_package(tmp_path):
    """The two-frame modules and tools, and a RAFT forward through
    GraphedForward2F and a train step, in a process that must not load
    jax or the JAX package."""
    code = """
import sys
import streamflow_tpu_torch.data.datasets
import streamflow_tpu_torch.models.raft
import streamflow_tpu_torch.tools.convert
import streamflow_tpu_torch.tools.evaluate
import streamflow_tpu_torch.tools.train_2f
from streamflow_tpu_torch.convert import convert_raft_checkpoint
from streamflow_tpu_torch.evaluation import GraphedForward2F
from streamflow_tpu_torch.models import create_model
from streamflow_tpu_torch.training.state import TrainState
from streamflow_tpu_torch.training.step import make_train_step_2f

import torch

model = create_model("skflow", device="cpu", iters=1,
                     mixed_precision=False)
x = torch.zeros(1, 16, 16, 3)
assert GraphedForward2F(model, 1)(x, x).shape == (1, 16, 16, 2)
train = create_model("raft_gma", device="cpu", iters=1, train=True,
                     mixed_precision=False)
state = TrainState.create(train, lr=1e-4, num_steps=10)
make_train_step_2f(iters=1)(state, {"images": torch.zeros(1, 2, 16, 16, 3),
                                    "flows": torch.zeros(1, 1, 16, 16, 2),
                                    "valids": torch.ones(1, 1, 16, 16)})
assert "jax" not in sys.modules, "jax imported"
bad = [m for m in sys.modules if m.split(".")[0] == "streamflow_tpu"]
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
