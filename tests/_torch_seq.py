"""Shared harness of the sequence-sharded forward's CPU tests (the
tests/test_torch_seq*.py files; not a test file): gloo ranks
(tests/_torch_seq_worker.py, rendezvous through a file store) against
the port's unsharded forward and JAX's unsharded ``model.apply(...,
test_mode=True)``, f32, the same fan-in-scaled random JAX variables of
each config through the bridge.

Tolerance: tests/test_torch_model.py's f32 parity bound (rtol 1e-4, atol
1e-5 x max(1, max |flow|)), tighter than JAX's own 2e-3 for its sharded
forward (tests/test_training_infra.py:323-341). The ranks of a seq group
return the same flows bit for bit. The slabs run the unsharded layers on
other shapes, so the CPU's matmuls may round differently: bits are not
required against the unsharded forward. A data rank d holds the rows
``even_split(B, n_data)[d]`` of the batch, none included.
"""

import functools
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

import _torch_seq_worker as worker
from _torch_parity import randomize_params
from streamflow_tpu.config import StreamFlowConfig as JaxConfig
from streamflow_tpu.models import create_model as jax_create
from streamflow_tpu_torch.parallel.exchange import even_split
from streamflow_tpu_torch.training.checkpoint import save_params_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def runs_of(groups):
    """(group, case, iters) of every sharded run of ``groups``."""
    return [(g, case, it) for g in groups
            for case, c in worker.GROUPS[g].items() for it in c.iters]


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want).max(
                                   initial=0.0)))


def _stats(tree, seed):
    """Running statistics: means 0.1 r, variances 0.5 + u (as
    tests/test_torch_zoo_model.py's)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if hasattr(v, "items") else (
            (0.5 + rng.random(np.shape(v))) if k == "var"
            else 0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in node.items()}
    return walk(tree)


def variables(fields, seed=1):
    """Fan-in-scaled random JAX variables of the config ``fields`` (f32,
    T=4), from the init's shapes (nothing compiled): every leaf random,
    the zero- and dirac-init hooks too, and the CNN cnet's BatchNorm
    running statistics where the config has them."""
    jm = jax_create("streamflow", cfg=JaxConfig(
        T=worker.T, iters=1, mixed_precision=False, **fields))
    shapes = jax.eval_shape(lambda k, a: jm.init(k, a, test_mode=True),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, worker.T, 64, 64, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    v = {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        randomize_params(zeros["params"], seed))}
    if "batch_stats" in zeros:
        v["batch_stats"] = _stats(zeros["batch_stats"], seed + 1)
    return v


def _env():
    return dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")


def _spawn(group, out):
    script = os.path.join(ROOT, "tests", "_torch_seq_worker.py")
    store = os.path.join(out, f"store_{group}")
    n = worker.WORLD[group]
    return [subprocess.Popen(
        [sys.executable, script, group, str(r), str(n), store, str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env()) for r in range(n)]


def _wait(procs, timeout):
    """Each process's (exit code, the end of its stderr); kills the rest
    if one outlasts ``timeout`` seconds."""
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            out.append((p.returncode, err[-4000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@functools.lru_cache(maxsize=None)
def _jax_forward(items, iters):
    """JAX's unsharded test-mode forward of the config ``items`` (its
    fields, sorted), jitted once for every clip of that shape."""
    jm = jax_create("streamflow", cfg=JaxConfig(
        T=worker.T, iters=iters, mixed_precision=False, **dict(items)))
    return jax.jit(lambda p, x: jm.apply(p, x, iters=iters, test_mode=True))


def _jax_flows(variables, fields, imgs, iters):
    """JAX's forward one clip at a time (the rows of a batch are
    independent; one compile serves every batch)."""
    fn = _jax_forward(tuple(sorted(fields.items())), iters)
    return np.concatenate([np.asarray(fn(variables, jnp.asarray(c[None])))
                           for c in imgs])


def start(groups, out):
    """Every group's ranks started at once, then JAX's and the port's
    unsharded forwards of each case computed while they run; returns
    the references and each rank's record."""
    configs = {worker.config_name(c.fields): c.fields for g in groups
               for c in worker.GROUPS[g].values()}
    jax_vars = {name: variables(fields) for name, fields in configs.items()}
    for name, v in jax_vars.items():
        save_params_npz(str(out / f"params_{name}.npz"), v)
    procs = {g: _spawn(g, out) for g in groups}
    jax_ref, port_ref = {}, {}
    try:
        for g, case, it in runs_of(groups):
            c = worker.GROUPS[g][case]
            imgs = worker.clip(c.h, c.w, c.b)
            key = (c.h, c.w, c.b, it, worker.config_name(c.fields),
                   c.fields.get("dw_impl", "auto"))
            if key not in jax_ref:   # cases of one clip share their refs
                jax_ref[key] = _jax_flows(
                    jax_vars[worker.config_name(c.fields)], c.fields, imgs,
                    it)
                model = worker.port_model(c.fields, str(out))
                port_ref[key] = model(torch.from_numpy(imgs), iters=it,
                                      test_mode=True).numpy()
            jax_ref[case, it], port_ref[case, it] = (jax_ref[key],
                                                     port_ref[key])
    finally:
        done = {g: _wait(p, timeout=600) for g, p in procs.items()}
    for g, results in done.items():
        for rc, err in results:
            assert rc == 0, f"{g}: {err}"
    recs = {g: [json.loads((out / f"{g}_{r}.json").read_text())
                for r in range(worker.WORLD[g])] for g in groups}
    return SimpleNamespace(out=out, jax=jax_ref, port=port_ref, recs=recs)


def rank_flows(runs, group, case, it):
    """Each rank's flows, and the rows of the batch it holds."""
    c = worker.GROUPS[group][case]
    flows = []
    for r in range(worker.WORLD[group]):
        a, b = even_split(c.b, c.n_data)[r // c.n_seq]
        flows.append((np.load(runs.out / f"{case}_{it}_{r}.npy"),
                      slice(a, b)))
    return flows


def parity_tests(runs_list):
    """The three tests of every sharded run in ``runs_list``, for a test
    module to bind (each module's ``runs`` fixture starts its groups)."""
    params = pytest.mark.parametrize("group,case,it", runs_list)

    @params
    def test_seq_sharded_matches_port_unsharded(runs, group, case, it):
        for got, rows in rank_flows(runs, group, case, it):
            want = runs.port[case, it][rows]
            assert got.shape == want.shape and got.dtype == np.float32
            close(got, want)

    @params
    def test_seq_sharded_matches_jax(runs, group, case, it):
        for got, rows in rank_flows(runs, group, case, it):
            close(got, runs.jax[case, it][rows])

    @params
    def test_seq_group_ranks_agree_bit_for_bit(runs, group, case, it):
        """The ranks of a seq group return the same whole flows."""
        n_seq = worker.GROUPS[group][case].n_seq
        flows = rank_flows(runs, group, case, it)
        for r, (got, _) in enumerate(flows):
            first = flows[r - r % n_seq][0]
            assert np.array_equal(got.view(np.uint32),
                                  first.view(np.uint32))

    return (test_seq_sharded_matches_port_unsharded,
            test_seq_sharded_matches_jax,
            test_seq_group_ranks_agree_bit_for_bit)


def record_tests(groups):
    """The test of every case's recorded forward in ``groups``, for a test
    module to bind (its ``runs`` fixture starts the groups)."""

    @pytest.mark.parametrize("group,case", [
        (g, case) for g in groups for case in worker.GROUPS[g]])
    def test_forward_exchanges_follow_the_plan(runs, group, case):
        """Every rank's last forward of the case (``exchange.recording``):
        halos, gathers and, under a CNN encoder alone, InstanceNorm's sums;
        each exchange's bytes sent and received ``traffic``'s; one
        all_reduce for each sum and none else (no halo or gather goes
        through an all_reduce of a zeroed buffer); the ranks of a seq
        group making the same exchanges in the same order; a data group
        without rows, or a seq group of one, none."""
        c = worker.GROUPS[group][case]
        recs = [r["forward"][case] for r in runs.recs[group]]
        for r, got in enumerate(recs):
            kinds = got["kinds"]
            a, b = even_split(c.b, c.n_data)[r // c.n_seq]
            assert got["planned"] and got["all_reduces"] == kinds.count(
                "sum")
            assert kinds == recs[r - r % c.n_seq]["kinds"]
            if a == b or c.n_seq == 1:
                assert kinds == []
                continue
            assert {"halo", "gather"} <= set(kinds) <= {"halo", "gather",
                                                        "sum"}
            assert ("sum" in kinds) == (c.fields.get("encoder")
                                        in worker.CNN)

    return test_forward_exchanges_follow_the_plan


def _halo_bytes(bounds, i, k, row):
    """Rank i's (sent, received) bytes of a halo of ``k`` by counting
    rows: it receives the rows of its window outside its slab, and sends
    each other rank the rows of its slab inside that rank's window."""
    total = bounds[-1][1]

    def window(j):
        a, b = bounds[j]
        return (set(range(max(a - k, 0), a)) | set(range(b, min(
            b + k, total)))) if b > a else set()
    mine = set(range(*bounds[i]))
    sent = sum(len(window(j) & mine) for j in range(len(bounds)) if j != i)
    return sent * row, len(window(i)) * row


def exchange_tests(group, sizes):
    """The tests of ``exchange_record`` on the slabs ``sizes`` in the
    world of ``group``, for a test module to bind."""
    bounds = worker._bounds(sizes)
    n = len(sizes)

    def test_halos_and_gathers_match_the_whole_grid(runs):
        """Halos of 1, 3 and 7 rows, slabs thinner than k included, hold
        the whole grid's rows; the gathers (unit 1 and 2) the whole grid,
        empty slabs present."""
        for r in runs.recs[group]:
            rec = r["exchange_record"]
            assert rec["halos"] == [True] * 3 and rec["gathers"] == [True] * 2

    def test_exchange_bytes_follow_the_plan(runs):
        """Each rank's recorded bytes sent and received: those of
        ``traffic``, and those counted row by row (halos: a (2, rows, 6)
        f32 slab, 48 bytes a row; gathers: n - 1 chunks of the largest
        slab each way, 48 bytes an entry, then a (3, 4, 2 x rows) bf16
        one, 24 bytes; the sum: 2(n-1)/n of its 8 bytes)."""
        most = max(sizes)
        for i, r in enumerate(runs.recs[group]):
            want = [_halo_bytes(bounds, i, k, 48) for k in (1, 3, 7)] + [
                ((n - 1) * most * 48,) * 2, ((n - 1) * most * 2 * 24,) * 2,
                (2 * (n - 1) * 8 / n,) * 2]
            got = r["exchange_record"]["bytes"]
            assert [e[0] for e in got] == ["halo"] * 3 + ["gather"] * 2 + [
                "sum"]
            assert [tuple(e[1:3]) for e in got] == want
            assert [tuple(e[3:5]) for e in got] == want

    def test_no_exchange_goes_through_an_all_reduce(runs):
        """One all_reduce, the sum's: the halos and gathers call none."""
        for r in runs.recs[group]:
            rec = r["exchange_record"]
            assert rec["all_reduces"] == rec["kinds"].count("sum") == 1

    return (test_halos_and_gathers_match_the_whole_grid,
            test_exchange_bytes_follow_the_plan,
            test_no_exchange_goes_through_an_all_reduce)
