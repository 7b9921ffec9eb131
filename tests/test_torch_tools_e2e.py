"""The port's measuring tools (streamflow_tpu_torch/tools: sweep_e2e,
trace_e2e, bench_input) and the profile grouping they share with
chip_smoke.py, on the CPU at a tiny size.

(g) ``sweep_e2e``'s spec parser maps JAX's short keys as JAX's
    ``_KEYMAP`` does (the same table; the same overrides for the keys the
    port honours) and raises, naming ROADMAP's ground rule, on the keys of
    the TPU kernel choices that the port's config accepts and ignores; a
    two-spec sweep runs on the CPU.
(h) ``tools/common.py::kernel_group`` classifies kernel names as the
    profile tables name them; chip_smoke.py's ``profile_device`` and
    ``trace_e2e`` use it; ``trace_e2e`` runs on the CPU.
(i) ``bench_input`` runs on a tiny Sintel tree with 1 and 2 workers.
Last, a subprocess imports every module of this slice (profiling, the
runtime, plots, the probes and these tools) and finds neither jax nor the
JAX package, nor PIL, cv2, h5py or matplotlib, loaded.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from streamflow_tpu_torch.tools import bench_input, sweep_e2e, trace_e2e
from streamflow_tpu_torch.tools.common import KERNEL_GROUPS, kernel_group
from tools import sweep_e2e as jax_sweep

torch.set_num_threads(4)
ROOT = Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--height", "64", "--width", "96"]


# ------------------------------------------------------------------ (g)
def test_sweep_keymap_is_jax_s():
    assert sweep_e2e._KEYMAP == jax_sweep._KEYMAP


@pytest.mark.parametrize("spec", [
    "default", "", "dw=pallas", "dw=banded_chain,iters=12",
    "iters=4,T=3", "B=2,dw=banded_mxu_t"])
def test_sweep_specs_parse_as_jax_s(spec):
    assert sweep_e2e.parse_spec(spec) == jax_sweep.parse_spec(spec)


@pytest.mark.parametrize("key", ["corr", "attn", "lga", "store", "unroll",
                                 "tffn", "bq", "lu", "lmaj", "lrows",
                                 "gelu"])
def test_sweep_refuses_the_ignored_tpu_keys(key):
    with pytest.raises(ValueError, match="Do not port the TPU workarounds"):
        sweep_e2e.parse_spec(f"dw=pallas,{key}=1")


@pytest.mark.parametrize("spec, match", [
    ("remat=1", "train step"), ("bidir=1", "train step"),
    ("nope=1", "no field"), ("k_conv=7", "not a scalar")])
def test_sweep_refuses_keys_a_forward_does_not_read(spec, match):
    with pytest.raises(ValueError, match=match):
        sweep_e2e.parse_spec(spec)


def test_sweep_runs_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "sweep.txt"
    rows = sweep_e2e.main(["dw=banded_chain,iters=1", "iters=1", *TINY,
                           "--reps", "1", "--results", str(out)])
    assert [r["spec"] for r in rows] == ["dw=banded_chain,iters=1",
                                         "iters=1"]
    for r in rows:
        assert r["ms_per_clip"] > 0
        assert len(r["ms_per_clip_rounds"]) == sweep_e2e.ROUNDS
        assert r["device_ms"] is None and r["device"] == "cpu"
        assert r["padded"] == [64, 96] and r["resolved"]["iters"] == 1
    assert rows[0]["resolved"]["dw"] == "banded_chain"
    # f32 stays f32 on a card (cuDNN's default is TF32)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(lines) == 2 * sweep_e2e.ROUNDS + 2 and lines[-1] == rows[-1]


# ------------------------------------------------------------------ (h)
@pytest.mark.parametrize("name, group", [
    ("(anonymous namespace)::corr_lookup_tile_kernel(CUtensorMap_st, ...)",
     "corr_lookup"),
    ("void (anonymous namespace)::ffn_pair_tc_kernel<1>(CUtensorMap_st)",
     "ffn_pair"),
    ("void (anonymous namespace)::ffn_pair_gemm_kernel<2>(...)", "ffn_pair"),
    ("void (anonymous namespace)::flash_fwd_wgmma_kernel<128>(...)",
     "flash_fwd"),
    ("void (anonymous namespace)::bwd_dq_wgmma<64>(...)", "flash_bwd"),
    ("void (anonymous namespace)::bwd_dkv_wgmma<128>(...)", "flash_bwd"),
    ("void (anonymous namespace)::bwd_split_wgmma<true>(...)", "flash_bwd"),
    ("void (anonymous namespace)::sk_chain_kernel<K8, 16>(...)",
     "sk_chain"),
    ("void (anonymous namespace)::dw_banded_t_kernel(...)", "dw_banded"),
    ("void (anonymous namespace)::dw_chain_f32_kernel(...)", "dw_chain"),
    ("void (anonymous namespace)::lga_kernel_bf16(...)", "lga_kernel"),
    ("void at::native::(anonymous namespace)::"
     "conv_depthwise2d_forward_kernel_generic<c10::BFloat16, int>", "conv"),
    ("conv2d_c1_k1_nhwc", "conv"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>",
     "elementwise"),
    ("void at::native::reduce_kernel<512, 1, ...>", "reduce"),
    ("void (anonymous namespace)::softmax_warp_forward<...>", "softmax"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel",
     "layer_norm"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>",
     "cat"),
    ("Memcpy DtoD (Device -> Device)", "other"),
    ("void at::native::index_elementwise_kernel<128, 4>", "elementwise")])
def test_kernel_group_classifies_profile_names(name, group):
    assert kernel_group(name) == group


def test_chip_smoke_and_trace_e2e_share_the_grouping():
    """chip_smoke.py's profile_device groups through tools/common.py and
    keeps no pattern table of its own; trace_e2e groups through it too."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "profile_device")
    names = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
    assert "device_time_by_group" in names
    consts = {n.value for n in ast.walk(fn) if isinstance(n, ast.Constant)}
    assert not consts & {pat for pat, _ in KERNEL_GROUPS} - {"corr_lookup"}
    src = (ROOT / "streamflow_tpu_torch" / "tools" / "trace_e2e.py"
           ).read_text()
    assert "kernel_group(name)" in src


def test_trace_e2e_runs_on_the_cpu(tmp_path):
    rec = trace_e2e.main(["iters=1", *TINY, "--raw", "4", "--results",
                          str(tmp_path / "t.txt")])
    assert rec["time"] == "host self (cpu)" and rec["total_ms"] > 0
    assert abs(sum(rec["groups_ms"].values()) - rec["total_ms"]) < 1e-6
    assert len(rec["top"]) == 4 and "conv" in rec["groups_ms"]
    lines = (tmp_path / "t.txt").read_text().splitlines()
    assert lines[0].startswith("trace_e2e 'iters=1': dw=auto iters=1")


# ------------------------------------------------------------------ (i)
def test_bench_input_runs_on_a_tiny_tree(tmp_path, capsys):
    rec = bench_input.main(["--bs", "2", "--crop", "64", "96", "--size",
                            "72", "104", "--nscenes", "2", "--frames", "6",
                            "--nbatches", "2", "--workers", "1", "2",
                            "--root", str(tmp_path)])
    assert rec["metric"] == "input_batches_per_sec"
    assert set(rec["by_workers"]) == {1, 2}
    assert all(v > 0 for v in rec["by_workers"].values())
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "6 clips; batch 2 at [64, 96]"
    assert json.loads(out[-1])["by_workers"].keys() == {"1", "2"}
    assert not list(tmp_path.iterdir())       # the tree is removed


def test_bench_input_names_a_tree_too_small_for_a_batch(tmp_path):
    with pytest.raises(ValueError, match="make 0 batch"):
        bench_input.main(["--bs", "8", "--crop", "64", "96", "--size", "72",
                          "104", "--nscenes", "1", "--frames", "6",
                          "--workers", "1", "--root", str(tmp_path)])


# ------------------------------------------------------------- imports
def test_the_slice_s_modules_load_neither_jax_nor_optional_packages():
    mods = ["streamflow_tpu_torch.utils",
            "streamflow_tpu_torch.utils.profiling",
            "streamflow_tpu_torch.utils.plots",
            "streamflow_tpu_torch.runtime",
            "streamflow_tpu_torch.data.frame_utils",
            "streamflow_tpu_torch.tools.probe_bf16",
            "streamflow_tpu_torch.tools.probe_guard",
            "streamflow_tpu_torch.tools.sweep_e2e",
            "streamflow_tpu_torch.tools.trace_e2e",
            "streamflow_tpu_torch.tools.bench_input"]
    code = "\n".join(["import sys", *(f"import {m}" for m in mods),
                      "bad = [m for m in sys.modules if m.split('.')[0] in "
                      "('jax', 'jaxlib', 'flax', 'streamflow_tpu', 'PIL', "
                      "'cv2', 'h5py', 'matplotlib')]",
                      "assert not bad, bad"])
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
