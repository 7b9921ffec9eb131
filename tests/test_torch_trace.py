"""The port's span recorder (streamflow_tpu_torch/utils/profiling.py) and
the spans on the served forward and the train step, on the CPU.

- Off (the default), ``span`` hands back one shared no-op context and
  reads no clock; nothing is recorded.
- On, spans nest (parent, unit), a raising block still closes its span,
  and the host stamps are on the profiler's clock: a span around a
  ``torch.mm`` holds the profile's ``aten::mm`` once ``trace_start_ns`` is
  subtracted.
- The device-span logic (events, chains, graph replays) with stand-in
  events: a chain shares one event between neighbours, and each replay of
  a captured graph gives records of its own under the span open at its
  call.
- A tiny StreamFlow test-mode forward gives the stages' spans, with one of
  each per-iteration name an iteration, and the same flows bit for bit as
  with the recorder off; a tiny train step gives its three phases (remat's
  recompute under the backward), the same loss and parameters.
- ``GraphedForward`` gives a ``serve`` unit and, on its replay path, the
  ``serve.*`` spans.
- ``tools/trace_spans.py`` runs on the CPU.
"""

import json
import time

import pytest
import torch

from streamflow_tpu_torch.config import StreamFlowConfig
from streamflow_tpu_torch.evaluation import GraphedForward, _Bucket
from streamflow_tpu_torch.models import create_model
from streamflow_tpu_torch.training.state import TrainState
from streamflow_tpu_torch.training.step import make_train_step
from streamflow_tpu_torch.utils import profiling

ITER_SPANS = ("corr.lookup", "update.motion", "update.gma_temporal",
              "update.gru_head")


@pytest.fixture(autouse=True)
def recorder():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _model(iters, train=False, remat=False):
    cfg = StreamFlowConfig(T=4, iters=iters, mixed_precision=False,
                           remat=remat)
    torch.manual_seed(0)
    return create_model("streamflow", cfg=cfg, device="cpu", train=train)


def _clip(seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(1, 4, 64, 96, 3, generator=g) * 255


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    assert profiling.span("a") is profiling.span("b", device=True)
    with profiling.span("a"):
        with profiling.span("b", device=True):
            pass
    with profiling.chain():
        pass
    profiling.replay(None)
    assert profiling.spans() == []


def test_nesting_gives_parent_and_unit_and_a_raise_closes():
    profiling.enable()
    with profiling.span("req"):
        with profiling.span("a"):
            with profiling.span("a.1"):
                pass
        with pytest.raises(ValueError):
            with profiling.span("b"):
                raise ValueError
    with profiling.span("next"):
        pass
    recs = {r.name: r for r in profiling.spans()}
    assert set(recs) == {"req", "a", "a.1", "b", "next"}
    req = recs["req"]
    assert req.parent is None and req.unit == req.id
    assert recs["a"].parent == req.id and recs["b"].parent == req.id
    assert recs["a.1"].parent == recs["a"].id
    assert {recs[n].unit for n in ("a", "a.1", "b")} == {req.id}
    assert recs["next"].parent is None and recs["next"].unit != req.id
    for r in recs.values():
        assert r.start_ns <= r.end_ns and r.device_ms is None
    assert req.start_ns <= recs["a"].start_ns <= recs["a.1"].end_ns \
        <= recs["b"].start_ns <= recs["b"].end_ns <= req.end_ns
    assert profiling._STACK == []


def test_a_span_holds_the_profiles_mm_on_its_clock():
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(600, 600)
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("mm"):
            a @ a
    (rec,) = profiling.spans()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    mms = [ev.time_range for ev in prof.events() if ev.name == "aten::mm"]
    assert len(mms) == 1
    assert (rec.start_ns - t0) / 1e3 <= mms[0].start
    assert mms[0].end <= (rec.end_ns - t0) / 1e3


class _Event:
    """A stand-in CUDA event: its time is the count of records so far."""
    clock = [0]

    def __init__(self, captured):
        self.captured, self.at = captured, None

    def record(self):
        _Event.clock[0] += 1
        self.at = _Event.clock[0]

    def synchronize(self):
        pass


@pytest.fixture
def fake_card(monkeypatch):
    """Device spans on the CPU: stand-in events, ms = records between."""
    capturing = [False]
    monkeypatch.setattr(profiling.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiling.torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    monkeypatch.setattr(profiling, "_event", _Event)
    monkeypatch.setattr(profiling, "_elapsed_ms",
                        lambda s, e: float(e.at - s.at))
    return capturing


def test_a_chain_shares_one_event_between_neighbours(fake_card):
    profiling.enable()
    with profiling.span("unit"):
        with profiling.chain():
            for name in ("a", "b", "c"):
                with profiling.span(name, device=True):
                    _Event(False).record()        # one op inside
        with profiling.span("d", device=True):
            pass
    opened = [o for o in profiling._EAGER]
    recs = {r.name: r for r in profiling.spans()}
    starts = {r.name: s for r, s, _ in opened}
    ends = {r.name: e for r, _, e in opened}
    assert starts["b"] is ends["a"] and starts["c"] is ends["b"]
    assert starts["d"] is not ends["c"]
    # a: its own start, the op, its end; b, c: the op and the end
    assert [recs[n].device_ms for n in "abcd"] == [2.0, 2.0, 2.0, 1.0]


def test_each_replay_of_a_captured_graph_is_recorded(fake_card):
    profiling.enable()
    with profiling.span("serve.capture"), profiling.capturing() as cap:
        fake_card[0] = True
        with profiling.chain():
            with profiling.span("x", device=True):
                pass
            with profiling.span("y", device=True):
                pass
        fake_card[0] = False
    assert [r.name for r, _, _ in cap.templates] == ["x", "y"]
    assert all(e.captured for _, s, e in cap.templates)
    events = {e for _, s, e in cap.templates} | {s for _, s, _ in
                                                 cap.templates}
    assert len(events) == 3                     # the chain's shared one

    def replay(gap):                 # the graph's nodes re-stamp its events
        for ev in sorted(events, key=lambda e: e.at):
            _Event.clock[0] += gap
            ev.at = _Event.clock[0]

    units = []
    for gap in (1, 5, 2):
        with profiling.span("serve") as unit, profiling.span(
                "serve.replay") as rep:
            profiling.replay(cap)
            replay(gap)
        units.append((unit.id, rep.id))
    recs = profiling.spans()
    timed = [r for r in recs if r.name in "xy" and r.device_ms is not None]
    assert len(timed) == 6
    for (uid, rid), gap in zip(units, (1, 5, 2)):
        mine = [r for r in timed if r.unit == uid]
        assert [r.name for r in mine] == ["x", "y"]
        assert all(r.parent == rid and r.start_ns is None for r in mine)
        assert [r.device_ms for r in mine] == [float(gap)] * 2
    profiling.reset()
    profiling.replay(cap)
    replay(3)
    assert [r.device_ms for r in profiling.spans()] == [3.0, 3.0]


def test_streamflow_forward_spans_and_flows_bit_for_bit():
    iters = 2
    model = _model(iters)
    x = _clip()
    with torch.no_grad():
        model(x, iters=iters, test_mode=True)   # a first call's zeros' signs
        want = model(x, iters=iters, test_mode=True)
        profiling.enable()
        got = model(x, iters=iters, test_mode=True)
    assert torch.equal(got, want)
    names = [r.name for r in profiling.spans()]
    assert names.count("encode") == 2 and names.count("corr.pyramid") == 1
    for n in ITER_SPANS:
        assert names.count(n) == iters, n
    assert set(names) == {"encode", "corr.pyramid", *ITER_SPANS}


def test_train_step_phases_same_loss_and_parameters():
    iters = 1

    def run(on):
        model = _model(iters, train=True, remat=True)
        state = TrainState.create(model, lr=1e-3, num_steps=10)
        g = torch.Generator().manual_seed(1)
        batch = {"images": _clip(1),
                 "flows": torch.randn(1, 3, 64, 96, 2, generator=g),
                 "valids": torch.ones(1, 3, 64, 96)}
        if on:
            profiling.enable()
        loss = make_train_step(0.85, iters)(state, batch)["loss"]
        profiling.disable()
        return loss, [p.detach().clone() for p in model.parameters()]

    (l0, p0), (l1, p1) = run(False), run(True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    recs = profiling.spans()
    by = {r.id: r for r in recs}
    (step,) = [r for r in recs if r.name == "step"]
    phases = {r.name: r for r in recs if r.parent == step.id}
    assert set(phases) == {"step.forward", "step.backward", "step.optimizer"}
    assert all(r.unit == step.id for r in recs)
    # remat's recompute of the loop runs the loop's spans again, inside
    # the backward; the encoders run once
    under = {}
    for r in recs:
        if r.parent in by and by[r.parent].name in phases:
            under.setdefault(by[r.parent].name, []).append(r.name)
    assert sorted(under["step.forward"]) == sorted(
        ["encode", "encode", "corr.pyramid", *ITER_SPANS])
    assert sorted(under["step.backward"]) == sorted(ITER_SPANS)


def test_graphed_forward_serve_spans():
    iters = 1
    model = _model(iters)
    fwd = GraphedForward(model, iters)
    x = _clip()
    profiling.enable()
    with torch.no_grad():
        eager = fwd(x)                         # the CPU runs eagerly
    recs = profiling.spans()
    (serve,) = [r for r in recs if r.name == "serve"]
    assert all(r.unit == serve.id for r in recs)

    class Graph:                               # the replay path's plumbing
        def __init__(self, bucket):
            self.bucket = bucket

        def replay(self):
            with torch.no_grad():
                self.bucket.out.copy_(model(self.bucket.images, iters=iters,
                                            test_mode=True))

    bucket = _Bucket(None, torch.zeros_like(x), None, torch.zeros_like(eager))
    bucket.graph = Graph(bucket)
    fwd.buckets[next(iter(fwd.buckets))] = bucket
    profiling.reset()
    got = fwd(x)
    assert torch.equal(got, eager)
    recs = profiling.spans()
    (serve,) = [r for r in recs if r.name == "serve"]
    kids = [r.name for r in recs if r.parent == serve.id]
    assert kids == ["serve.copy_in", "serve.replay", "serve.copy_out"]


def test_trace_spans_tool_runs_on_the_cpu(tmp_path):
    from streamflow_tpu_torch.tools import trace_spans

    common = ["--device", "cpu", "--height", "32", "--width", "64",
              "--iters", "1", "--batch", "1", "--rounds", "1",
              "--results", str(tmp_path / "r.txt")]
    out = trace_spans.main(["infer", "--seconds", "0.05",
                            "--trace-seconds", "0.05", *common])
    assert out["flows_equal"] and out["time"] == "host (cpu)"
    assert out["units"] == out["requests"] >= 1
    assert set(out["stages_ms"]) == {"encode", "corr", "sk", "gma_temporal"}
    out = trace_spans.main(["train", "--steps", "1", "--trace-steps", "1",
                            *common])
    assert out["off_on_equal"] and out["units"] == 1
    assert set(out["phases_ms"]) == {"step.forward", "step.backward",
                                     "step.optimizer"}
    assert "step.backward/update.motion" in out["model_spans_ms"]
    lines = (tmp_path / "r.txt").read_text().splitlines()
    assert [json.loads(s)["what"] for s in lines] == ["infer", "train"]
    assert not profiling.enabled()


def test_phase_timer_is_a_span():
    profiling.phase_reset()
    profiling.enable()
    with profiling.phase_timer("p"):
        time.sleep(0.001)
    (rec,) = profiling.spans()
    assert rec.name == "p"
    assert profiling.phase_report()["p"]["count"] == 1
    profiling.phase_reset()


def test_the_recorder_and_its_tool_load_no_jax():
    import subprocess
    import sys
    from pathlib import Path

    code = "\n".join([
        "import sys",
        "import streamflow_tpu_torch.tools.trace_spans",
        "import streamflow_tpu_torch.evaluation",
        "import streamflow_tpu_torch.training.step",
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'streamflow_tpu')]",
        "assert not bad, bad"])
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
