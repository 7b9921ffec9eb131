"""BENCHMARK.json and the files the harness finds by its names: every
cell, configuration, traffic mix, limit and metric is a file of its own,
and a new one is only new files and new entries."""

from __future__ import annotations

import json
import re
import shutil
import time

import pytest

from sfbench import cell as cells
from sfbench.tests import conftest
from sfbench.tests.conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads(BENCH.read_text())


def test_contract_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["sfbench"] and 1 <= b["run_seconds"] <= 51
    assert len(BENCH.read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        lim = 0.25
        assert 0.01 <= m["bound"] <= lim
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("sfbench/")
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


@pytest.mark.parametrize("name", [w["name"] for w in json.loads(
    BENCH.read_text())["workloads"]])
def test_every_cell_loads_and_reports(name):
    """Each cell finds its files, reports setup_s, another end-to-end
    metric and a per-layer metric, and each of its per-layer metrics moves
    an end-to-end metric that the cell reports."""
    c = cells.load(name, BENCH)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (name, m["name"])
        assert callable(cells.metric_reader(m["name"]).read)
    assert cells.driver(c).run
    ref = c.reference
    assert c.limits and ref.__name__.endswith("reference." + c.model)
    assert all(callable(getattr(ref, f)) for f in ("forward", "sk_blocks",
                                                    "mlps"))


def test_metric_files_name_their_layer_and_target():
    for m in bench()["per_layer"]:
        doc = cells.metric_reader(m["name"]).__doc__
        assert doc.startswith(m["name"] + ":"), m["name"]
        assert f"Moves {m['moves']}" in " ".join(doc.split())


def test_a_cell_and_metric_added_from_files(tmp_path):
    """A new configuration, mix, cell, limit and per-layer metric are new
    files and new BENCHMARK.json entries; nothing that exists changes."""
    files = tmp_path / "sfbench"
    shutil.copytree(ROOT / "sfbench", files,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in files.rglob("*") if p.is_file()}
    b = bench()
    cfg = json.loads((ROOT / "sfbench/configs/streamflow_canonical.json")
                     .read_text())
    (files / "configs" / "streamflow_t3.json").write_text(
        json.dumps(dict(cfg, T=3)))
    traffic = json.loads((files / "traffic" / "sintel_clips.json")
                         .read_text())
    (files / "traffic" / "sintel_clips_t3.json").write_text(
        json.dumps(dict(traffic, frames=3)))
    (files / "limits" / "sf_t3_infer.json").write_text(
        json.dumps({"flow_gap": 0.05}))
    (files / "metrics" / "requests.infer.py").write_text(
        '"""requests.infer: requests in the traced slice. Layer: serving. '
        'Moves flows_per_s."""\n\n\ndef read(view):\n    return '
        'float(view.units)\n')
    b["configs"].append({"name": "streamflow_t3", "source": "x",
                         "file": "sfbench/configs/streamflow_t3.json",
                         "reduced": ["T"], "why": "three frames"})
    b["workloads"].append({"name": "sf_t3_infer", "config": "streamflow_t3",
                           "traffic": "sintel_clips_t3", "chips": 1,
                           "why": "T=3"})
    b["per_layer"].append({"name": "requests.infer", "unit": "count",
                           "better": "higher", "source": "device_trace",
                           "layer": "serving", "moves": "flows_per_s",
                           "workloads": ["sf_t3_infer"]})
    for m in b["end_to_end"]:
        if "workloads" in m and "sf_sintel_infer" in m["workloads"]:
            m["workloads"].append("sf_t3_infer")
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(b))
    c = cells.load("sf_t3_infer", path, files)
    assert c.config["T"] == 3 and c.traffic["frames"] == 3
    assert "requests.infer" in [m["name"] for m in c.per_layer]

    from sfbench.counts.profile import Trace
    from sfbench.view import View

    view = View(c, Trace([("k", 0.0, 10.0)], [], 1.0, 7), 1e12)
    got = cells.read_metrics(c, view, files)
    assert got["requests.infer"] == {"value": 7.0, "unit": "count"}
    assert all(p.read_bytes() == data for p, data in before.items())


PAIRS_REFERENCE = '''"""A two-frame model added from files: SKFlow's
reference under another name."""
from sfbench.reference import skflow

forward, sk_blocks, mlps = skflow.forward, skflow.sk_blocks, skflow.mlps
'''


def test_a_model_added_from_files(tmp_path):
    """A new model is its reference file and its configuration's file (the
    port's registry name, config class and serving entry); its counts
    come from its own reference. A model without a reference file is
    refused, not taken for another."""
    from sfbench.counts import flops, kernels

    files = tmp_path / "sfbench"
    shutil.copytree(ROOT / "sfbench", files,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in files.rglob("*") if p.is_file()}
    (files / "reference" / "pairs.py").write_text(PAIRS_REFERENCE)
    cfg = json.loads((files / "configs" / "skflow.json").read_text())
    (files / "configs" / "pairs.json").write_text(
        json.dumps(dict(cfg, model="pairs")))
    (files / "configs" / "nothing.json").write_text(
        json.dumps(dict(cfg, model="nothing")))
    (files / "limits" / "pairs_infer.json").write_text(
        json.dumps({"flow_gap": 0.05}))
    (files / "limits" / "nothing_infer.json").write_text(
        json.dumps({"flow_gap": 0.05}))
    b = bench()
    for name in ("pairs", "nothing"):
        b["configs"].append({"name": name, "source": "x", "reduced": [],
                             "file": f"sfbench/configs/{name}.json",
                             "why": "a model from files"})
        b["workloads"].append({"name": f"{name}_infer", "config": name,
                               "traffic": "sintel_pairs", "chips": 1,
                               "why": "two frames"})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(b))
    c = cells.load("pairs_infer", path, files)
    sk = cells.load("skflow_sintel_infer", conftest.bench())
    assert c.reference.__file__ == str(files / "reference" / "pairs.py")
    assert kernels.work("dwconv", c.reference, c.config, c.traffic) == \
        kernels.work("dwconv", sk.reference, sk.config, sk.traffic)
    small = dict(c.traffic, padded=[64, 96], iters=1)
    from sfbench import program

    _, specs, _ = program.build(sk, 1, "cpu")
    assert flops.infer_flops(c.reference, c.config, small, specs) == \
        flops.infer_flops(sk.reference, sk.config, small, specs)
    with pytest.raises(ValueError, match="nothing"):
        cells.load("nothing_infer", path, files).reference
    assert all(p.read_bytes() == data for p, data in before.items())


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.load("no_such_cell", BENCH)


def test_run_refuses_without_a_card_and_prints_nothing(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files,
    and on a machine without a card, a run exits non-zero with no
    result."""
    import subprocess
    import sys

    shutil.copy(BENCH, tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "sfbench", tmp_path / "sfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    t0 = time.time()
    p = subprocess.run([sys.executable, "sfbench/run.py", "--workload",
                        "sf_sintel_infer", "--seed", str(2 ** 31 + 5),
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == "", (p.stdout, p.stderr)
    assert time.time() - t0 < 300
