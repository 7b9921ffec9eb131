"""The port's training infrastructure against the JAX package's, on the CPU:
the loader (bit for bit), the device prefetch's CPU form, the OneCycle
schedule as the optimizer drives it and clipping + AdamW (optax; f32,
1e-6 relative), the metrics logger's records, the checkpoint manager,
and exact resume (port only, bit for bit)."""

import json
import os
import re
import threading
import time

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from streamflow_tpu.data.loader import DataLoader as JLoader
from streamflow_tpu.training import optim as JO
from streamflow_tpu.utils.logger import MetricsLogger as JLogger
from streamflow_tpu_torch.config import StreamFlowConfig
from streamflow_tpu_torch.data.loader import DataLoader, prefetch_to_device
from streamflow_tpu_torch.models import create_model
from streamflow_tpu_torch.tools.common import init_weights
from streamflow_tpu_torch.training.checkpoint import CheckpointManager
from streamflow_tpu_torch.training.optim import (clip_by_global_norm,
                                                 global_norm, make_optimizer)
from streamflow_tpu_torch.training.state import TrainState
from streamflow_tpu_torch.training.step import make_train_step
from streamflow_tpu_torch.utils.logger import MetricsLogger

torch.set_num_threads(2)


class Clips:
    """An in-memory dataset with the loader's interface: each sample drawn
    from the generator the loader hands it (the bithings keys too)."""

    def __init__(self, n, t=3, h=6, w=8, bidir=False):
        self.n, self.t, self.h, self.w, self.bidir = n, t, h, w, bidir

    def __len__(self):
        return self.n

    def load(self, index, rng):
        f, h, w = self.t - 1, self.h, self.w
        s = {"images": rng.integers(0, 256, (self.t, h, w, 3)).astype(
                 np.float32) + index,
             "flows": rng.standard_normal((f, h, w, 2)).astype(np.float32),
             "valids": (rng.random((f, h, w)) < 0.8).astype(np.float32),
             "frame_ids": np.arange(index, index + self.t, dtype=np.int32)}
        if self.bidir:
            s["flows_bw"] = rng.standard_normal((f, h, w, 2)).astype(
                np.float32)
            s["valids_bw"] = np.ones((f, h, w), np.float32)
        return s


@pytest.mark.parametrize("process_count", [1, 2])
@pytest.mark.parametrize("bidir", [False, True])
def test_loader_matches_the_jax_loader_bit_for_bit(process_count, bidir):
    ds = Clips(11, bidir=bidir)
    for rank in range(process_count):
        kw = dict(batch_size=2, num_workers=3, seed=7, process_index=rank,
                  process_count=process_count)
        port, ref = DataLoader(ds, **kw), JLoader(ds, **kw)
        assert len(port) == len(ref) == 11 // process_count // 2
        for epoch in (0, 1):
            got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
            assert len(got) == len(want) == len(port)
            for g, w in zip(got, want):
                assert set(g) == set(w)
                for k in w:
                    assert g[k].dtype == w[k].dtype
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_loader_raises_a_worker_error_and_stops_early():
    class Broken(Clips):
        def load(self, index, rng):
            if index == 5:
                raise ValueError("unreadable clip 5")
            return super().load(index, rng)

    with pytest.raises(ValueError, match="unreadable clip 5"):
        list(DataLoader(Broken(8), 2, shuffle=False, num_workers=2).epoch())
    threads = threading.active_count()
    it = DataLoader(Clips(40), 2, num_workers=2, prefetch=1).epoch()
    next(it)
    it.close()      # the producer stops instead of blocking on the queue
    deadline = time.monotonic() + 10
    while threading.active_count() > threads and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == threads


def test_prefetch_to_device_on_the_cpu_keeps_order_and_values():
    batches = list(DataLoader(Clips(9), 2, num_workers=2, seed=3).epoch())
    for depth in (1, 2, 3):
        got = list(prefetch_to_device(iter(batches), "cpu", depth=depth))
        assert len(got) == len(batches)
        for g, w in zip(got, batches):
            assert set(g) == set(w)
            for k in w:
                assert isinstance(g[k], torch.Tensor)
                np.testing.assert_array_equal(g[k].numpy(), w[k])


@pytest.mark.parametrize("pct_start", [0.05, 0.2])
def test_the_optimizers_schedule_matches_optax_step_for_step(pct_start):
    lr, num_steps = 6e-4, 400
    want = JO.onecycle_linear(lr, num_steps + 100, pct_start)
    w = torch.zeros(3, requires_grad=True)
    opt, sched = make_optimizer([w], lr, num_steps, pct_start=pct_start)
    for n in range(num_steps + 120):
        # optax evaluates in f32: its rounding is ~1e-7 of max_lr
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(want(n)),
                                   rtol=1e-6, atol=1e-7 * lr,
                                   err_msg=f"step {n}")
        opt.step()
        sched.step()


def test_clip_then_adamw_matches_optax():
    """Three updates of the same params from the same random gradients
    (global norms ~30, so a clip of 0.5 scales them all): the port's
    clip_by_global_norm + AdamW, with the clip read from the train state,
    against optax's chain of make_optimizer."""
    rng = np.random.default_rng(0)
    shapes = [(4, 5), (7,), (3, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[10 * rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    kw = dict(lr=1e-2, num_steps=50, weight_decay=1e-2, epsilon=1e-8,
              clip=0.5, pct_start=0.2)

    tx = JO.make_optimizer(**kw)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, upd)

    model = torch.nn.ParameterList(torch.nn.Parameter(torch.from_numpy(p))
                                   for p in params)
    state = TrainState.create(model, kw["lr"], kw["num_steps"],
                              kw["weight_decay"], kw["epsilon"], kw["clip"],
                              kw["pct_start"])
    assert state.clip == 0.5
    for g in grads:
        for p, x in zip(model, g):
            p.grad = torch.from_numpy(x.copy())
        gs = [p.grad for p in model]
        norm = global_norm(gs)
        assert float(norm) > 10 * state.clip
        clip_by_global_norm(gs, state.clip, norm)
        state.optimizer.step()
        state.scheduler.step()
    for p, want in zip(model, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_metrics_logger_writes_the_jax_loggers_records(tmp_path, capsys):
    rng = np.random.default_rng(1)
    pushes = [({"loss": float(rng.random()), "epe": float(rng.random())},
               float(rng.random()) * 1e-4) for _ in range(7)]
    vals = {3: {"clean_epe": 2.5, "clean_1px": 0.1},
            6: {"clean_epe": 2.25, "clean_1px": 0.2}}
    lines = {}
    for name, cls in (("jax", JLogger), ("port", MetricsLogger)):
        log = cls(str(tmp_path / name), num_steps=7, print_freq=2)
        log.step = 1                       # as after a resume
        for i, (m, lr) in enumerate(pushes):
            log.push(m, lr=lr if i != 6 else None)
            if log.step in vals:
                log.push_val(log.step, vals[log.step])
        assert log.best_step("clean_epe") == 6
        assert log.best_step("kitti_epe") is None
        log._jsonl.close()
        # the printed lines, their s/it and ETA aside
        lines[name] = [re.sub(r"\| .*", "", ln)
                       for ln in capsys.readouterr().out.splitlines()]
    assert lines["port"] == lines["jax"] and len(lines["jax"]) == 4
    got = _records(tmp_path / "port" / "metrics.jsonl")
    assert got == _records(tmp_path / "jax" / "metrics.jsonl")
    assert [r["step"] for r in got] == [2, 3, 4, 6, 6, 8]


def _tiny_state(seed, clip=1.0):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Linear(8, 2))
    return TrainState.create(model, lr=1e-3, num_steps=20, clip=clip)


def _tiny_steps(state, n):
    g = torch.Generator().manual_seed(100 + state.step)
    for _ in range(n):
        state.optimizer.zero_grad()
        state.model(torch.randn(5, 4, generator=g)).square().mean().backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1


def _assert_states_equal(a, b):
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert a.scheduler.last_epoch == b.scheduler.last_epoch
    assert a.step == b.step and a.lr == b.lr


def test_checkpoint_manager_keeps_n_and_survives_a_failed_save(
        tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tiny_state(0))
    state = _tiny_state(0)
    for _ in range(4):
        _tiny_steps(state, 1)
        assert mgr.save(state)
    assert not mgr.save(state)            # step 4 is saved already
    mgr.wait_until_finished()
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    # a temporary file left by a crash is not a step
    (tmp_path / "step_9.pt.tmp123").write_bytes(b"partial")
    assert mgr.all_steps() == [3, 4]
    fresh = mgr.restore(_tiny_state(1))
    _assert_states_equal(fresh, state)

    # a save that fails leaves the earlier checkpoints as they were
    before = {p.name: p.read_bytes() for p in tmp_path.glob("step_*.pt")}
    _tiny_steps(state, 1)

    def broken(obj, fh):
        fh.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    mgr.save(state)
    with pytest.raises(RuntimeError, match="a save failed"):
        mgr.wait_until_finished()
    monkeypatch.undo()
    assert mgr.all_steps() == [3, 4]
    assert {p.name: p.read_bytes()
            for p in tmp_path.glob("step_*.pt")} == before
    assert sorted(os.listdir(tmp_path)) == ["step_3.pt", "step_4.pt",
                                           "step_9.pt.tmp123"]
    assert mgr.restore(_tiny_state(2), step=3).step == 3
    mgr.close()


def _clip_batches(n, t=3, h=32, w=48):
    rng = np.random.default_rng(4)
    return [{"images": rng.integers(0, 255, (1, t, h, w, 3)).astype(
                 np.float32),
             "flows": (4 * rng.standard_normal((1, t - 1, h, w, 2))).astype(
                 np.float32),
             "valids": np.ones((1, t - 1, h, w), np.float32)}
            for _ in range(n)]


def _streamflow_state(seed=5):
    cfg = StreamFlowConfig(T=3, iters=1, mixed_precision=False, remat=True)
    model = create_model("streamflow", cfg=cfg, device="cpu", train=True)
    init_weights(model, seed)
    return TrainState.create(model, lr=1e-3, num_steps=10, clip=0.5)


def test_resume_is_exact(tmp_path):
    """k + m steps straight equal k steps, a checkpoint, a restore into a
    fresh model and optimizer, then m steps: bit for bit. The step clips to
    the state's clip: after it, the gradients' global norm is 0.5."""
    k, m = 2, 2
    batches = [{kk: torch.from_numpy(v) for kk, v in b.items()}
               for b in _clip_batches(k + m)]
    step = make_train_step(gamma=0.8, iters=1)

    straight = _streamflow_state()
    for b in batches:
        met = step(straight, b)
        assert float(met["grad_norm"]) > 0.5
        clipped = global_norm([p.grad for p in straight.model.parameters()])
        np.testing.assert_allclose(float(clipped), 0.5, rtol=1e-5)

    first = _streamflow_state()
    for b in batches[:k]:
        step(first, b)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(first, wait=True)
    resumed = mgr.restore(_streamflow_state(seed=6))
    _assert_states_equal(resumed, first)
    for b in batches[k:]:
        step(resumed, b)
    _assert_states_equal(resumed, straight)
