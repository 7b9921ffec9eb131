"""The port's native IO runtime (streamflow_tpu_torch/runtime, libsfio built
with g++ from its own sfio.cpp), its profiling hooks
(utils/profiling.py) and its training curves (utils/plots.py), on the
CPU.

(d) The native decoders against the NumPy codecs bit for bit (one .flo,
    a batch of .flo files, a .ppm written by PIL), as tests/test_runtime.py
    holds JAX's, and against the JAX package's readers; the data layer
    reads .flo and .ppm through them (read_flo, read_gen, read_image, the
    FlyingChairs dataset) without loading PIL; a garbage, truncated or
    missing file and a batch of mixed sizes raise, and so does a build
    that fails (with the compiler's message).
(e) ``phase_timer`` accumulates per name (with and without ``sync``),
    ``phase_report`` gives totals, counts and means; ``trace_ctx`` writes a
    Chrome trace, the program's spans on its timeline.
(f) ``plot_training_curves`` writes JAX's png files from a
    ``MetricsLogger`` file, and returns [] without one or without
    matplotlib.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from streamflow_tpu.data import frame_utils as jfu
from streamflow_tpu.utils import plots as jplots
from streamflow_tpu_torch import runtime
from streamflow_tpu_torch.data import frame_utils as fu
from streamflow_tpu_torch.utils import plots, profiling
from streamflow_tpu_torch.utils.logger import MetricsLogger

ROOT = Path(__file__).resolve().parent.parent


# ------------------------------------------------------------------ (d)
@pytest.mark.parametrize("shape", [(30, 40), (1, 1), (436, 1024)])
def test_native_flo_matches_numpy(tmp_path, shape):
    rng = np.random.default_rng(0)
    flow = rng.standard_normal((*shape, 2)).astype(np.float32)
    p = tmp_path / "a.flo"
    fu.write_flo(p, flow)
    got = runtime.read_flo_native(p)
    assert got.dtype == np.float32 and got.shape == (*shape, 2)
    np.testing.assert_array_equal(got, fu.read_flo_numpy(p))
    np.testing.assert_array_equal(got, flow)
    np.testing.assert_array_equal(fu.read_flo(p), got)
    np.testing.assert_array_equal(fu.read_gen(p), jfu.read_gen(p))


def test_native_flo_batch_matches_numpy(tmp_path):
    rng = np.random.default_rng(1)
    paths = []
    for i in range(8):
        p = tmp_path / f"{i}.flo"
        fu.write_flo(p, rng.standard_normal((12, 16, 2)).astype(np.float32))
        paths.append(p)
    got = runtime.read_flo_batch_native(paths)
    np.testing.assert_array_equal(
        got, np.stack([fu.read_flo_numpy(p) for p in paths]))


def test_native_ppm_matches_pil(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 255, (21, 17, 3), dtype=np.uint8)
    p = tmp_path / "x.ppm"
    Image.fromarray(img).save(p)
    for got in (runtime.read_ppm_native(p), fu.read_gen(p),
                fu.read_image(p)):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(fu.read_image(p), jfu.read_image(p))
    # a comment line and other whitespace in the header
    q = tmp_path / "y.ppm"
    q.write_bytes(b"P6\n# a comment\n17  21\n255\n" + img.tobytes())
    np.testing.assert_array_equal(runtime.read_ppm_native(q), img)


@pytest.mark.parametrize("content, error, match", [
    (b"not a flow file", ValueError, "bad .flo magic"),
    (b"", ValueError, "shorter"),
    (np.array([202021.25], np.float32).tobytes()
     + np.array([4, 3], np.int32).tobytes() + b"\0" * 20, ValueError,
     "shorter"),
    (np.array([202021.25], np.float32).tobytes()
     + np.array([-4, 3], np.int32).tobytes(), ValueError, "bad size"),
    (None, OSError, "cannot be opened")])
def test_native_flo_refuses_bad_files(tmp_path, content, error, match):
    p = tmp_path / "bad.flo"
    if content is not None:
        p.write_bytes(content)
    with pytest.raises(error, match=match):
        fu.read_flo(p)


def test_native_ppm_and_batch_refuse_bad_files(tmp_path):
    p = tmp_path / "bad.ppm"
    p.write_bytes(b"P5\n2 2\n255\n" + b"\0" * 4)
    with pytest.raises(ValueError, match="not a binary P6"):
        fu.read_image(p)
    p.write_bytes(b"P6\n2 2\n65535\n" + b"\0" * 24)
    with pytest.raises(ValueError, match="maxval"):
        runtime.read_ppm_native(p)
    p.write_bytes(b"P6\n4 4\n255\n" + b"\0" * 10)
    with pytest.raises(ValueError, match="shorter"):
        runtime.read_ppm_native(p)
    a, b = tmp_path / "a.flo", tmp_path / "b.flo"
    fu.write_flo(a, np.zeros((4, 5, 2), np.float32))
    fu.write_flo(b, np.zeros((5, 4, 2), np.float32))
    with pytest.raises(ValueError, match="differs in size"):
        runtime.read_flo_batch_native([a, b])
    with pytest.raises(ValueError, match="no paths"):
        runtime.read_flo_batch_native([])


def test_a_failed_build_raises_with_the_compiler_message(tmp_path,
                                                         monkeypatch):
    src = tmp_path / "sfio.cpp"
    src.write_text("int broken( {\n")
    monkeypatch.setattr(runtime, "_SRC", src)
    monkeypatch.setattr(runtime, "_BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building libsfio failed"
                       r"(.|\n)*error"):
        runtime._compile()
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_library_builds_into_build_under_its_source_hash():
    lib = runtime.get_lib()
    assert lib is runtime.get_lib()
    built = list((ROOT / "build" / "streamflow_tpu_torch").glob(
        "libsfio_*.so"))
    assert built and runtime._compile() in built


def test_chairs_frames_load_through_the_runtime_without_pil(tmp_path):
    """FlyingChairs' .ppm frames and .flo flows are read by the native
    decoders: a process that reads a sample loads no PIL."""
    from _torch_serving import chairs_tree

    data = chairs_tree(tmp_path / "chairs")
    code = f"""
import sys
from streamflow_tpu_torch.data.datasets import FlyingChairs
ds = FlyingChairs(root={data!r})
s = ds.load(0)
assert s["images"].shape[0] == 2 and s["flows"].shape[0] == 1, s.keys()
bad = [m for m in sys.modules if m.split(".")[0] in ("PIL", "cv2")]
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    from streamflow_tpu.data.datasets import FlyingChairs as JChairs
    from streamflow_tpu_torch.data.datasets import FlyingChairs

    got = FlyingChairs(root=data).load(1)
    want = JChairs(root=data).load(1)
    for k in ("images", "flows", "valids"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------------ (e)
def test_phase_timer_counts_and_reports():
    profiling.phase_reset()
    for sync in (None, torch.zeros(3), "cpu"):
        with profiling.phase_timer("a", sync=sync):
            time.sleep(0.01)
    with profiling.phase_timer("b"):
        pass
    rep = profiling.phase_report()
    assert set(rep) == {"a", "b"}
    assert rep["a"]["count"] == 3 and rep["b"]["count"] == 1
    assert rep["a"]["total_s"] >= 0.03
    assert rep["a"]["mean_s"] == pytest.approx(rep["a"]["total_s"] / 3)
    with pytest.raises(ZeroDivisionError):
        with profiling.phase_timer("c"):
            1 / 0
    assert profiling.phase_report()["c"]["count"] == 1
    profiling.phase_reset()
    assert profiling.phase_report() == {}


def test_trace_ctx_writes_a_chrome_trace(tmp_path):
    assert not profiling.enabled()
    with profiling.trace_ctx(str(tmp_path / "trace")):
        with profiling.span("outer"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert not profiling.enabled()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert "aten::mm" in names
    # the program's span beside the profiler's events, on their timeline
    (mm,) = [ev for ev in trace["traceEvents"] if ev.get("name") == "aten::mm"]
    (outer,) = [ev for ev in trace["traceEvents"]
                if ev.get("cat") == "program_span"]
    assert outer["name"] == "outer" and outer["args"]["parent"] is None
    assert outer["ts"] <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= outer["ts"] + outer["dur"]
    profiling.reset()


# ------------------------------------------------------------------ (f)
def _metrics(out):
    log = MetricsLogger(str(out), num_steps=6, print_freq=2)
    for i in range(6):
        log.push({"loss": 3.0 - 0.1 * i, "epe": 2.0 - 0.2 * i}, lr=1e-4)
        if i % 3 == 2:
            log.push_val(i + 1, {"sintel_clean": 1.5 - 0.1 * i,
                                 "sintel_final": 2.5 - 0.1 * i})
    log.close()


def test_plot_training_curves_writes_jax_pngs(tmp_path):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    for d in (ours, theirs):
        _metrics(d)
    got = plots.plot_training_curves(str(ours))
    want = jplots.plot_training_curves(str(theirs))
    assert [Path(p).name for p in got] == [Path(p).name for p in want] == [
        "train_epe.png", "val_sintel_clean.png", "val_sintel_final.png"]
    for p in got:
        assert Path(p).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_plot_training_curves_without_a_file_or_matplotlib(tmp_path,
                                                           monkeypatch):
    assert plots.plot_training_curves(str(tmp_path)) == []
    _metrics(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert plots.plot_training_curves(str(tmp_path)) == []
    assert not list(tmp_path.glob("*.png"))
    assert os.path.exists(tmp_path / "metrics.jsonl")
