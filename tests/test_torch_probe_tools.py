"""The four kernel probes ported from the JAX package's tools/
(``streamflow_tpu_torch/tools/probe_lookup.py``, ``probe_cmajor_ffn.py``,
``probe_gelu_ffn.py``, ``probe_1080p_fault.py``): each tool's ``main``
on the CPU at a tiny shape (the plain versions; no time measured), the
1080p probe's in-process, subprocess and stress forms, that the tools
and the new kernel modules import neither jax nor the JAX package, and
the kernel-against-plain rule and bound that the probes and
``chip_smoke.py`` share (``tools/common.py``)."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from streamflow_tpu_torch.tools import (probe_1080p_fault, probe_cmajor_ffn,
                                        probe_gelu_ffn, probe_lookup)
from streamflow_tpu_torch.tools.common import (bf16_ulp, bound_ms,
                                               close_err, roofline_ms)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def test_probe_lookup_main_on_the_cpu(capsys):
    rows = probe_lookup.main(["--device", "cpu", "--height", "128",
                              "--width", "192", "--reps", "1"])
    assert [r["mode"] for r in rows] == list(probe_lookup.ORDER)
    for r in rows:
        assert r["within"] and r["ms"] is None and r["bound_ms"] > 0
        assert r["out"].shape == (1, 16, 24, 324)
        assert r["out"].dtype == torch.bfloat16
    assert "not measured" in capsys.readouterr().out


def test_probe_cmajor_ffn_main_on_the_cpu():
    rows = probe_cmajor_ffn.main(["--device", "cpu", "--tokens", "200",
                                  "--reps", "1"])
    assert [(r["c"], r["ch"]) for r in rows] == [(256, 384), (384, 640)]
    for r in rows:
        assert r["within"] and r["ms"] is None
        assert r["out"].shape == (r["c"], 200)
        # the transpose of the row-major pair, up to bf16 rounding
        assert r["err_vs_row_major"] <= 2.0 ** -9 * float(
            r["plain"].float().abs().max()) + 0.05


def test_probe_gelu_ffn_main_on_the_cpu():
    rows = probe_gelu_ffn.main(["poly", "64", "300", "--all", "--device",
                                "cpu", "--reps", "1"])
    assert [r["gelu"] for r in rows] == ["erf", "poly", "tanh", "tanh",
                                         "poly", "erf"]
    errs = {r["gelu"]: r["max_abs_err_vs_f32_erf"] for r in rows}
    assert all(0 < e < 0.1 for e in errs.values())
    one = probe_gelu_ffn.main(["tanh", "64", "100", "--device", "cpu"])
    assert [r["gelu"] for r in one] == ["tanh"]


def _args(*extra):
    return ["--device", "cpu", "--lkp_h", "16", "--lkp_w", "24", *extra]


@pytest.mark.parametrize("name", ["lookup_model", "lookup_flash",
                                  "lookup_ffn", "ffn_alone"])
def test_probe_1080p_chained_probes_on_the_cpu(name, capsys):
    r = probe_1080p_fault.main(_args(name))
    assert r["ok"] and r["ms"] is None and r["max_abs_err"] == 0.0
    assert capsys.readouterr().out.startswith(f"{name}: OK")


def test_probe_1080p_registry_and_stress():
    assert list(probe_1080p_fault.PROBES) == [
        "lga1", "lga2", "lookup", "flash_gma", "flash_gsa1", "flash_gsa2",
        "lookup_model", "lookup_flash", "lookup_ffn", "ffn_alone"]
    res = subprocess.run(
        [sys.executable, "-m", "streamflow_tpu_torch.tools.probe_1080p_fault",
         "stress", "ffn_alone", "1", *_args()[2:], "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "stress ffn_alone: 1/1 ok" in res.stdout


def test_tools_and_kernels_import_no_jax():
    mods = ["streamflow_tpu_torch.tools.probe_lookup",
            "streamflow_tpu_torch.tools.probe_cmajor_ffn",
            "streamflow_tpu_torch.tools.probe_gelu_ffn",
            "streamflow_tpu_torch.tools.probe_1080p_fault",
            "streamflow_tpu_torch.ops.kernels.corr_lookup_probe",
            "streamflow_tpu_torch.ops.kernels.ffn_pair_cmajor"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m.split('.')[0] == 'streamflow_tpu']\n"
              "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_close_err_rule(dt):
    """f32: atol = rtol = 1e-4; bf16: 2 ulp of the plain value + 2^-9
    max|plain|; the rule of ``dt`` when one is given, else want's."""
    want = torch.tensor([0.0, 0.5, -3.0, 100.0]).to(dt)
    if dt == torch.float32:
        step = 1e-4 + 1e-4 * want.abs()
    else:
        step = 2 * bf16_ulp(want) + 2.0 ** -9 * 100.0
    inside = (want.float() + 0.5 * step).to(torch.float32)
    outside = (want.float() + 2.5 * step).to(torch.float32)
    err, ok = close_err(inside, want.float(), dt)
    assert ok and err == pytest.approx(float((0.5 * step).max()), rel=1e-3)
    assert not close_err(outside, want.float(), dt)[1]
    assert not close_err(torch.full_like(want, float("nan")), want)[1]
    assert close_err(want[:0], want[:0]) == (0.0, True)


def test_bound_ms_takes_the_io_type():
    # 989 TFLOP/s bf16, 67 f32, 3.35 TB/s
    assert roofline_ms(989e9, 3.35e9) == pytest.approx((1.0, 1.0))
    assert roofline_ms(67e9, 0, torch.float32)[0] == pytest.approx(1.0)
    assert bound_ms(2 * 989e9, 3.35e9) == (pytest.approx(2.0), "operations")
    assert bound_ms(67e9, 2 * 3.35e9, "float32") == (pytest.approx(2.0),
                                                      "bytes")
