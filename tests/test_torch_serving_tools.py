"""Port parity of the submission writers (submission.py) against the JAX
package's, and the port's serving tools (streamflow_tpu_torch/tools:
evaluate, submit, demo, test_memory, bench) run on the CPU at a tiny
size, with the same weights on synthetic trees.

Tolerances: flows written by the two packages agree as their forwards do
(test_torch_model.py: rtol 1e-4, atol 1e-5 max|flow|); a KITTI png to
one 1/64 px quantum (a value within rounding of a quantum's edge may
fall on either side); the evaluate tool's metrics as
test_torch_serving_eval.py holds the validators (EPE rtol 1e-4, rates
within 2 pixels' worth of their denominator), the two-frame
``--model raft --dataset chairs`` command as JAX's validate_chairs (EPE
rtol 1e-4)."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_raft import jax_raft
from _torch_serving import (H, ITERS, T, W, chairs_tree, kitti_tree,
                            served_pair, shared_jax_forward, sintel_tree,
                            spring_tree)

from streamflow_tpu import evaluation as jev
from streamflow_tpu import submission as jsub
from streamflow_tpu.training import checkpoint as jckpt
from streamflow_tpu_torch import submission
from streamflow_tpu_torch.data import frame_utils

ROOT = Path(__file__).resolve().parent.parent
torch.set_num_threads(4)


@pytest.fixture(scope="module", autouse=True)
def _one_jax_forward():
    with shared_jax_forward():
        yield


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("serving_tools")
    return {"sintel": sintel_tree(base / "sintel"),
            "kitti": kitti_tree(base / "kitti"),
            "spring": spring_tree(base / "spring"),
            "chairs": chairs_tree(base / "chairs")}


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """The shared weights, written by the JAX package's save_params_npz."""
    _, params, _ = served_pair()
    path = str(tmp_path_factory.mktemp("ckpt") / "params.npz")
    jckpt.save_params_npz(path, params)
    return path


def test_npz_written_by_jax_loads_into_the_port(npz):
    """JAX's save_params_npz -> the port's load_variables_npz -> load_jax:
    the port's test-mode forward equals JAX's apply within
    test_torch_model.py's tolerance (rtol 1e-4, atol 1e-5 max|flow|)."""
    import jax.numpy as jnp

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.params import load_jax
    from streamflow_tpu_torch.training import checkpoint

    jm, params, _ = served_pair()
    model = create_model("streamflow", cfg=StreamFlowConfig(
        T=T, iters=ITERS, mixed_precision=False), device="cpu")
    load_jax(model, checkpoint.load_variables_npz(npz))
    imgs = np.random.default_rng(2).integers(0, 255, (1, T, H, W, 3)).astype(
        np.float32)
    got = model(torch.from_numpy(imgs), test_mode=True).numpy()
    want = np.asarray(jev.JittedForward(jm, params, ITERS)(jnp.asarray(imgs)))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def _close_flows(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("writer", ["sintel", "sintel_warm", "kitti",
                                    "spring"])
def test_submission_writers_match_jax(trees, tmp_path, writer):
    jm, params, tm = served_pair()
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    if writer == "sintel":
        kw = dict(root=trees["sintel"], iters=ITERS, nframes=T,
                  dstypes=("clean",), save_vis_flow=True)
        submission.create_sintel_submission(tm, output_path=out, **kw)
        jsub.create_sintel_submission(jm, params, output_path=jout, **kw)
    elif writer == "sintel_warm":
        kw = dict(root=trees["sintel"], iters=ITERS, nframes=T,
                  dstypes=("final",))
        submission.create_sintel_submission_warm(tm, output_path=out, **kw)
        jsub.create_sintel_submission_warm(jm, params, output_path=jout,
                                           **kw)
    elif writer == "kitti":
        kw = dict(multi_root=trees["kitti"], iters=ITERS, nframes=T)
        submission.create_kitti_submission(tm, output_path=out, **kw)
        jsub.create_kitti_submission(jm, params, output_path=jout, **kw)
    else:
        kw = dict(root=trees["spring"], iters=ITERS, nframes=T)
        submission.create_spring_submission(tm, output_path=out, **kw)
        jsub.create_spring_submission(jm, params, output_path=jout, **kw)
    names = _files(out)
    assert names == _files(jout)
    # Sintel: temple_1's 4 pairs (its tail window's 2 marked -1); KITTI:
    # one png a sequence; Spring: test/0001 5 and test/0002 3 pairs a
    # direction and camera
    expected = {"sintel": 4, "sintel_warm": 4, "kitti": 3, "spring": 32}
    flows = [n for n in names if not (writer == "sintel" and
                                      n.endswith(".png"))]
    assert len(flows) == expected[writer], names
    for name in flows:
        a, b = os.path.join(out, name), os.path.join(jout, name)
        if name.endswith(".flo"):
            _close_flows(frame_utils.read_flo(a), frame_utils.read_flo(b))
        elif name.endswith(".flo5"):
            _close_flows(frame_utils.read_flo5(a), frame_utils.read_flo5(b))
        else:
            (fa, va), (fb, vb) = (frame_utils.read_flow_kitti(p)
                                  for p in (a, b))
            assert np.abs(fa - fb).max() <= 1 / 64 and (va == vb).all()


def test_evaluate_tool_matches_jax_validate_sintel(trees, npz, capsys):
    from streamflow_tpu_torch.tools import evaluate

    jm, params, _ = served_pair()
    got = evaluate.main(["--dataset", "sintel", "--device", "cpu", "--fp32",
                         "--ckpt", npz, "--iters", str(ITERS), "--T",
                         str(T), "--sintel_root", trees["sintel"]])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert printed == str(got)
    want = jev.validate_sintel(jm, params, trees["sintel"], ITERS, T,
                               progress=False)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if "epe" in k:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
        else:   # 10 pairs of 64 x 96 per pass
            assert abs(got[k] - v) <= 2 / (10 * H * W), (k, got[k], v)
    # the two-frame command on a chairs tree, against JAX's
    # validate_chairs with the same RAFT weights (an npz written by JAX)
    jm2, v2 = jax_raft("raft", False)
    npz2 = str(Path(trees["chairs"]).parent / "raft.npz")
    jckpt.save_params_npz(npz2, v2)
    got = evaluate.main(["--dataset", "chairs", "--model", "raft",
                         "--device", "cpu", "--fp32", "--ckpt", npz2,
                         "--iters", str(ITERS), "--chairs_root",
                         trees["chairs"]])
    want = jev.validate_chairs(jm2, v2, trees["chairs"], ITERS)
    assert got.keys() == want.keys() == {"chairs_epe"}
    np.testing.assert_allclose(got["chairs_epe"], want["chairs_epe"],
                               rtol=1e-4)


def test_submit_tool_writes_the_kitti_pngs(trees, npz, tmp_path, capsys):
    from streamflow_tpu_torch.tools import submit

    out = tmp_path / "kitti"
    submit.main(["--dataset", "kitti", "--device", "cpu", "--fp32",
                 "--ckpt", npz, "--iters", "1", "--multi_root",
                 trees["kitti"], "--output", str(out)])
    assert _files(out) == [f"{i:06d}_10.png" for i in range(3)]
    assert "written to" in capsys.readouterr().out


def test_test_memory_and_bench_tools_run_on_the_cpu(capsys):
    from streamflow_tpu_torch.tools import bench, test_memory

    res = test_memory.main(["--device", "cpu", "--height", "44", "--width",
                            "60", "--iters", "1", "--loops", "2", "--fp32"])
    out = capsys.readouterr().out
    assert "loop 1:" in out and "OK: 2 loops at 48x64" in out
    assert len(res["loop_s"]) == 2 and res["peak_gib"] is None
    bench.main(["--device", "cpu", "--height", "60", "--width", "90",
                "--iters", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == (
        "streamflow_sintel_60x90_T4_1iters_frames_per_sec_per_cpu")
    assert line["unit"] == "frames/s/cpu" and line["value"] > 0
    assert line["padded"] == [64, 96] and line["device_ms"] is None
    # on the CPU the "kernel" path is the plain path: the guard reads 0
    assert line["rel_epe_vs_f32_plain_1iter"] == 0.0
    assert line["rel_epe_p99_vs_f32_plain_1iter"] == 0.0


def _jax_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_demo", ROOT / "tools" / "demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_sliding_windows_match_jax():
    from streamflow_tpu_torch.tools.demo import sliding_windows

    jax_windows = _jax_demo().sliding_windows
    for t in (3, 4):
        for n in range(4, 21):
            got = sliding_windows(n, t)
            assert got == jax_windows(n, t), (n, t)
            kept = sum(sum(keep) for _, keep in got)
            assert kept == n - 1, (n, t)   # every pair once


def test_demo_tool_writes_a_flow_video(tmp_path, capsys):
    import cv2

    from streamflow_tpu_torch.tools import demo

    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 255, (44, 60, 3), dtype=np.uint8)
              for _ in range(6)]
    video = str(tmp_path / "in.mp4")
    demo.write_video(video, frames, 10.0)
    out = str(tmp_path / "flow.mp4")
    demo.main(["--video", video, "--output", out, "--device", "cpu",
               "--fp32", "--iters", "1"])
    assert "wrote 5 flow frames" in capsys.readouterr().out
    cap = cv2.VideoCapture(out)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 5


def test_serving_modules_and_tools_load_neither_jax_nor_the_jax_package():
    code = """
import sys
import streamflow_tpu_torch.data
import streamflow_tpu_torch.data.augmentor
import streamflow_tpu_torch.data.mf_datasets
import streamflow_tpu_torch.evaluation
import streamflow_tpu_torch.ops.warp
import streamflow_tpu_torch.submission
import streamflow_tpu_torch.tiling
import streamflow_tpu_torch.training.checkpoint
import streamflow_tpu_torch.tools.bench
import streamflow_tpu_torch.tools.demo
import streamflow_tpu_torch.tools.evaluate
import streamflow_tpu_torch.tools.submit
import streamflow_tpu_torch.tools.test_memory
import streamflow_tpu_torch.layers.basic_encoder
import streamflow_tpu_torch.layers.twins
import streamflow_tpu_torch.data.datasets
import streamflow_tpu_torch.tools.convert
import streamflow_tpu_torch.tools.train_2f
from streamflow_tpu_torch.evaluation import GraphedForward, GraphedForward2F
from streamflow_tpu_torch.models import create_model

import torch

model = create_model("streamflow", device="cpu", encoder="basic", T=2,
                     iters=1, mixed_precision=False)
GraphedForward(model, 1)(torch.zeros(1, 2, 16, 16, 3))
raft = create_model("raft", device="cpu", iters=1, mixed_precision=False)
GraphedForward2F(raft, 1)(torch.zeros(1, 16, 16, 3),
                          torch.zeros(1, 16, 16, 3))
assert "jax" not in sys.modules, "jax imported"
bad = [m for m in sys.modules if m.split(".")[0] == "streamflow_tpu"]
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
