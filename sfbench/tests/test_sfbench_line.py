"""The result line of a run: the contract's keys, the cell's metrics by
name and unit, the checks last, ``correct`` from the checks."""

from __future__ import annotations

import json
import sys
from pathlib import Path

from sfbench.counts.profile import Trace
from sfbench.view import View

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import run  # noqa: E402  (sfbench/run.py, as the command runs it)


def _res(cell, checks):
    return {"metrics": {"flows_per_s": 31.2, "latency_ms_p95": 95.8,
                        "peak_mem_gib": 0.13}, "setup_s": 10.4,
            "checks": checks, "attempted": 200, "failed": 0}


def test_untraced_line(tiny):
    c = tiny("sf_sintel_infer")
    dev = {"platform": "gpu", "kind": "x", "count": 1,
           "memory_peak_bytes": 1}
    line = run.result_line(c, _res(c, [("flow_gap", 0.004, 0.022),
                                       ("nonfinite", 0, 0)]), False, dev)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"flows_per_s", "latency_ms_p95",
                                    "peak_mem_gib", "setup_s"}
    assert line["metrics"]["flows_per_s"] == {"value": 31.2,
                                              "unit": "flows/s"}
    assert line["checks"]["flow_gap"] == {"value": 0.004, "limit": 0.022}
    json.dumps(line)
    bad = run.result_line(c, _res(c, [("flow_gap", 0.5, 0.022)]), False, dev)
    assert bad["correct"] is False


def test_traced_line(tiny):
    c = tiny("sf_sintel_infer")
    tr = Trace([("ffn_pair_tc_kernel<0, 1>", 0.0, 3e5),
                ("conv_depthwise2d_forward_kernel_generic", 3.1e5, 5e5),
                ("Memcpy HtoD (Pinned -> Device)", 5e5, 5.1e5)],
               [("cudaGraphLaunch", 2.9e5, 3.2e5)], 0.6, 10)
    tr.rest = (1.0, 10)
    res = dict(_res(c, [("flow_gap", 0.004, 0.022)]),
               view=View(c, tr, 6e12))
    line = run.result_line(c, res, True, {"platform": "gpu"})
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert set(line["metrics"]) == {"copy_ms.infer", "mfu.infer",
                                    "ffn_pair_roofline", "dwconv_roofline",
                                    "idle_share.infer"}
    assert line["metrics"]["copy_ms.infer"]["value"] == 1.0
    # 6e12 FLOPs a request in 0.1 s: 6e13 / 989e12
    assert abs(line["metrics"]["mfu.infer"]["value"]
               - 100 * 6e13 / 989e12) < 1e-9
    # busy 0.5 s (the union) of the 0.6 s slice
    assert abs(line["metrics"]["idle_share.infer"]["value"] - 100 / 6) < 1e-9
    assert line["breakdown"]["idle_gaps"][0][0] == "cudaGraphLaunch"
    assert len(line["breakdown"]["device_ops"]) == 3


def test_a_reader_with_nothing_to_read_is_left_out(tiny):
    c = tiny("sf_sintel_infer")
    res = dict(_res(c, [("flow_gap", 0.004, 0.022)]),
               view=View(c, Trace([], [], 1.0, 3), 6e12))
    line = run.result_line(c, res, True, {"platform": "gpu"})
    assert "ffn_pair_roofline" not in line["metrics"]
    assert "idle_share.infer" not in line["metrics"]


def test_forbidden_modules_compare_whole_names(monkeypatch):
    for name in [m for m in sys.modules
                 if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "streamflow_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    monkeypatch.setitem(sys.modules, "streamflow_tpu.models", sys)
    assert run.forbidden_modules() == ["jaxlib", "streamflow_tpu"]
