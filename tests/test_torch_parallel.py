"""The port's data-parallel training (streamflow_tpu_torch/parallel/,
training/step.py::shard_train_step) on the CPU: two gloo processes
(tests/_torch_dist_worker.py, rendezvous through a file store) against the
JAX package's unsharded step on the same global batch.

(a) For the canonical config, 'basic' (BatchNorm cnet: the statistics
    synced over the ranks, against flax's over the global batch), the
    bithings fold (the reversed clip folded into the batch), 'basic'
    bidirectional (two applications) and RAFT's ``make_train_step_2f``:
    one step of two ranks, one row each, against JAX's ``make_train_step``
    / ``make_train_step_2f`` (f32, 32x32, iters=1, T=4, lr 1e-4, AdamW,
    clip 1.0) on both rows, through ``params.from_jax``, at JAX's own
    tolerances for its sharded step (tests/test_training_infra.py:
    173-182): loss and epe (epe_bw) rtol 1e-5, parameters atol 3e-5 and
    rtol 2e-3; the running statistics 1e-5; the gradients' norm 1e-4
    (tests/test_torch_train.py's port-vs-JAX bound). The ranks hold 90%
    and 35% valid pixels, so a mean of the ranks' masked means would not
    be the global one.
(b) The ranks' parameters, statistics and metrics equal bit for bit after
    each of two steps.
(c) A group of one rank: ``shard_train_step`` equal to the plain step bit
    for bit over two steps (losses, metrics, gradients' norm, parameters,
    statistics, AdamW's state), canonical and 'basic'.
(d) tools/train.py::train with two ranks: the checkpoints written by rank
    0 alone, the validations on rank 0 alone, an exact resume on both
    ranks, the ranks' final states equal.
(e) tools/dryrun_multichip.py with two processes, both modes.
(f) ``initialize``: nothing configured is one process, (0, 1); a bad
    coordinator raises; ``make_mesh``, ``shard_batch``.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from _torch_parity import randomize_params
from streamflow_tpu.config import RAFTConfig as JaxRAFTConfig
from streamflow_tpu.config import StreamFlowConfig as JaxConfig
from streamflow_tpu.models import create_model as jax_create
from streamflow_tpu.training import optim as JO
from streamflow_tpu.training.state import TrainState as JState
from streamflow_tpu.training.step import make_train_step as j_make_step
from streamflow_tpu.training.step import make_train_step_2f as j_make_step_2f
from streamflow_tpu_torch import parallel
from streamflow_tpu_torch.params import _flatten, to_jax_variables
from streamflow_tpu_torch.training.checkpoint import save_params_npz

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LOSS_RTOL = 1e-5                    # JAX's sharded-step test
PARAM_ATOL, PARAM_RTOL = 3e-5, 2e-3
STATS_RTOL, NORM_RTOL = 1e-5, 1e-4


def _jax_model(name):
    kind, fields, _ = worker.CASES[name]
    if kind == "raft":
        return jax_create("raft", cfg=JaxRAFTConfig(
            iters=worker.ITERS, mixed_precision=False, **fields))
    return jax_create("streamflow", cfg=JaxConfig(
        T=worker.T, iters=worker.ITERS, mixed_precision=False, **fields))


def _variables(name, jm, seed=1):
    """Random params (fan-in scaled), running means 0.1 r and variances
    0.5 + u, from the init's shapes (nothing compiled)."""
    kind = worker.CASES[name][0]
    x = jnp.zeros((1, worker.H, worker.W, 3), jnp.float32)
    if kind == "raft":
        shapes = jax.eval_shape(lambda k, a, b: jm.init(k, a, b,
                                                        test_mode=True),
                                jax.random.PRNGKey(0), x, x)
    else:
        shapes = jax.eval_shape(
            lambda k, a: jm.init(k, a, test_mode=True),
            jax.random.PRNGKey(0), jnp.zeros((1, worker.T) + x.shape[1:]))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    v = {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        randomize_params(zeros["params"], seed))}
    if "batch_stats" in zeros:
        rng = np.random.default_rng(seed + 1)
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: (0.5 + rng.random(a.shape) if p[-1].key == "var"
                          else 0.1 * rng.standard_normal(a.shape)
                          ).astype(np.float32), zeros["batch_stats"])
    return v


def _jax_step(name, jm, v):
    """JAX's unsharded step on the whole global batch: (metrics, flat
    params, flat batch_stats)."""
    kind, _, bidir = worker.CASES[name]
    tx = JO.make_optimizer(worker.LR, 100)
    gamma = worker.GAMMA[kind]
    if kind == "raft":
        step = j_make_step_2f(jm, tx, gamma=gamma, iters=worker.ITERS)
    else:
        step = j_make_step(jm, tx, gamma=gamma, iters=worker.ITERS,
                           bidirectional=bidir)
    state = JState.create({"params": v["params"]}, tx, model_state={
        k: w for k, w in v.items() if k != "params"})
    batch = {k: jnp.asarray(a) for k, a in worker.global_batch(kind).items()}
    state, metrics = jax.jit(step)(state, batch)
    out = jax.tree_util.tree_map(np.asarray, state.model_state)
    return ({k: float(m) for k, m in metrics.items()},
            _flatten(jax.tree_util.tree_map(np.asarray,
                                            state.params["params"])),
            _flatten(out.get("batch_stats", {})))


def _env():
    return dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="2")


def _spawn(mode, out):
    script = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
    store = os.path.join(out, f"store_{mode}")
    return [subprocess.Popen(
        [sys.executable, script, mode, str(r), str(WORLD), store, str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env()) for r in range(WORLD)]


def _wait(procs, timeout):
    """Wait for every process (``timeout`` seconds each), killing the rest
    if one outlasts it; returns each one's (exit code, stdout, the end of
    its stderr)."""
    out = []
    try:
        for p in procs:
            stdout, err = p.communicate(timeout=timeout)
            out.append((p.returncode, stdout, err[-4000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _ok(results):
    for rc, _, err in results:
        assert rc == 0, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the file checks, run at once: the workers' two-rank
    steps, the two-rank trainer and the dryrun tool are started first,
    then JAX's unsharded step of each case is computed while they run.
    The steps' workers must succeed; the trainer's and the dryrun's
    results are held by their own tests."""
    out = tmp_path_factory.mktemp("dist")
    trainer_out = tmp_path_factory.mktemp("trainer")
    models = {name: _jax_model(name) for name in worker.CASES}
    variables = {name: _variables(name, jm) for name, jm in models.items()}
    for name, v in variables.items():
        save_params_npz(str(out / f"{name}.npz"), v)
    steps, trainer = _spawn("steps", out), _spawn("trainer", trainer_out)
    dryrun = subprocess.Popen(
        [sys.executable, "-m", "streamflow_tpu_torch.tools.dryrun_multichip",
         "--n", str(WORLD), "--device", "cpu"], cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ref = {name: _jax_step(name, models[name], variables[name])
               for name in worker.CASES}
    finally:
        done = _wait(steps + trainer + [dryrun], timeout=600)
    _ok(done[:WORLD])
    ranks = {name: [torch.load(out / f"{name}_{r}.pt", weights_only=False)
                    for r in range(WORLD)] for name in worker.CASES}
    solo = [json.loads((out / f"solo_{r}.json").read_text())
            for r in range(WORLD)]
    return SimpleNamespace(ref=ref, ranks=ranks, solo=solo,
                           trainer_out=trainer_out,
                           trainer=done[WORLD:-1], dryrun=done[-1])


def _port_flat(name, sd):
    kind, fields, _ = worker.CASES[name]
    v = to_jax_variables(sd, cfg=worker.port_config(kind, fields))
    return v["params"], v.get("batch_stats", {})


@pytest.mark.parametrize("name", list(worker.CASES))
def test_two_ranks_loss_and_metrics_match_jax(runs, name):
    ref, ranks = runs.ref, runs.ranks
    want, got = ref[name][0], ranks[name][0]["m1"]
    assert set(got) == set(want)
    for k in ("loss", "epe") + (("epe_bw",) if "epe_bw" in want else ()):
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=NORM_RTOL)


@pytest.mark.parametrize("name", list(worker.CASES))
def test_two_ranks_params_match_jax(runs, name):
    ref, ranks = runs.ref, runs.ranks
    _, want, want_stats = ref[name]
    got, got_stats = _port_flat(name, ranks[name][0]["sd1"])
    assert set(got) == set(want)
    for path, p in got.items():
        np.testing.assert_allclose(p, want[path], atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=path)
    assert set(got_stats) == set(want_stats)
    assert bool(got_stats) == (name in ("basic", "basic_bidir", "raft"))
    for path, s in got_stats.items():
        np.testing.assert_allclose(s, want_stats[path], rtol=STATS_RTOL,
                                   atol=1e-6, err_msg=path)


@pytest.mark.parametrize("name", list(worker.CASES))
def test_ranks_stay_equal_bit_for_bit(runs, name):
    ranks = runs.ranks
    a, b = ranks[name]
    for i in (1, 2):
        assert a[f"m{i}"] == b[f"m{i}"]
        sa, sb = a[f"sd{i}"], b[f"sd{i}"]
        assert set(sa) == set(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (i, k)
    for i, s in a["opt"]["state"].items():
        for k, v in s.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(b["opt"]["state"][i][k]))


@pytest.mark.parametrize("rank", range(WORLD), ids=["canonical", "basic"])
def test_one_rank_group_equals_plain_step(runs, rank):
    solo = runs.solo[rank]
    assert solo["case"] == ("canonical", "basic")[rank]
    assert solo == dict(case=solo["case"], metrics1=True, metrics2=True,
                        state=True, optimizer=True, synced=True)


def test_metrics_are_global_masked_means(runs):
    """The ranks hold different valid counts: the step's epe is the sum of
    their masked sums over the sum of their counts (JAX's global masked
    mean), which the mean of their means misses by far more than the
    tolerance."""
    ref, ranks = runs.ref, runs.ranks
    sums = [r["local_epe"] for r in ranks["canonical"]]
    counts = [c for _, c in sums]
    assert max(counts) > 2 * min(counts)
    glob = sum(s for s, _ in sums) / sum(counts)
    want = ref["canonical"][0]["epe"]
    np.testing.assert_allclose(glob, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(ranks["canonical"][0]["m1"]["epe"], glob,
                               rtol=1e-6)
    naive = np.mean([r["local_mean_epe"] for r in ranks["canonical"]])
    assert abs(naive - want) > 1e3 * LOSS_RTOL * want


def test_trainer_two_ranks(runs):
    """tools/train.py::train on two ranks: global batch 2, 4 steps, a
    checkpoint and a validation at steps 2 and 4."""
    out = runs.trainer_out
    _ok(runs.trainer)
    recs = [json.loads((out / f"trainer_{r}.json").read_text())
            for r in range(WORLD)]
    assert recs[0]["writes"] == [2, 4] and recs[1]["writes"] == []
    assert [r["validations"] for r in recs] == [2, 0]
    assert [r["fwd"] for r in recs] == [True, False]
    assert all(r["step"] == 4 and r["resume_exact"] for r in recs)
    assert all(r["steps"] == [2, 4] for r in recs)
    run = out / "run" / "streamflow"
    assert (run / "best.npz").exists()
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 6      # 4 steps, 2 validations: rank 0 alone
    a, b = (torch.load(out / f"trainer_{r}.pt") for r in range(WORLD))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_dryrun_multichip_both_modes(runs):
    _ok([runs.dryrun])
    stdout = runs.dryrun[1]
    lines = [ln for ln in stdout.splitlines()
             if ln.startswith("dryrun_multichip(2)")]
    assert len(lines) == 2, stdout
    assert lines[0].startswith("dryrun_multichip(2): ok, loss=")
    assert lines[1].startswith(
        "dryrun_multichip(2): bf16+remat+bidirectional ok, loss=")


def test_initialize_without_configuration_is_one_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.initialize() == (0, 1)
    assert not torch.distributed.is_initialized()
    assert parallel.is_primary()
    parallel.barrier("alone")            # a no-op
    assert parallel.make_mesh() is None
    with pytest.raises(ValueError):
        parallel.initialize(num_processes=2)   # nowhere to meet


def test_initialize_bad_coordinator_raises(tmp_path):
    with pytest.raises(ValueError):
        parallel.initialize("no-port-here", 2, 0, device="cpu")
    with pytest.raises(ValueError):
        parallel.initialize("127.0.0.1:1234", 2, None, device="cpu")
    # a rank that waits for peers that never come: the rendezvous times out
    with pytest.raises(Exception):
        parallel.initialize(f"file://{tmp_path / 'store'}", 2, 1,
                            device="cpu", timeout_s=2)
    assert not torch.distributed.is_initialized()


def test_make_mesh_and_shard_batch():
    # the seq axis needs a group of n_data x n_seq processes (A10b,
    # tests/test_torch_seq.py); one process has none
    with pytest.raises(ValueError, match="needs a process group"):
        parallel.make_mesh(n_seq=2)
    with pytest.raises(ValueError):
        parallel.make_mesh(n_data=2)
    batch = {"images": np.arange(12).reshape(4, 3),
             "valids": np.arange(4)}
    parts = [parallel.shard_batch(batch, r, 2) for r in range(2)]
    np.testing.assert_array_equal(parts[1]["images"], batch["images"][2:])
    np.testing.assert_array_equal(
        np.concatenate([p["valids"] for p in parts]), batch["valids"])
    with pytest.raises(ValueError):
        parallel.shard_batch(batch, 0, 3)
