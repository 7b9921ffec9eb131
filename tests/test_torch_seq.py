"""The port's sequence-sharded forward (streamflow_tpu_torch/parallel/
seq.py, exchange.py; JAX's parallel/seq.py::make_seq_sharded_forward) on
the CPU: gloo ranks (tests/_torch_seq_worker.py, rendezvous through a
file store) against the port's unsharded forward and JAX's unsharded
``model.apply(..., test_mode=True)``, f32, the same fan-in-scaled random
JAX variables through the bridge.

(i)   n_seq=2 at 112x128, T=4, iters 1 and 2 (decoder slabs 7/7, fnet
      28/28, cnet 28/14 stage-2 rows);
(ii)  n_seq=3 at 168x128, iters 1 (7/7/7: a rank with two neighbours);
(iii) n_data=2 x n_seq=2, B=2, at 112x128, iters 1;
(iv)  dw_impl='pallas' at n_seq=2, iters 1;
(v)   a seq group of one (one process; and make_mesh(n_data=2)'s data
      group of two) bit for bit with ``model.forward``;
(vi)  the slab planner's boundaries;
(vii) the ValueErrors and NotImplementedErrors;
(viii) GSA's flash switch on a slab follows the whole grid's tokens.

Tolerance: tests/test_torch_model.py's f32 parity bound (rtol 1e-4, atol
1e-5 x max(1, max |flow|)), tighter than JAX's own 2e-3 for its sharded
forward (tests/test_training_infra.py:323-341). The ranks of a seq group
return the same flows bit for bit. The slabs run the unsharded layers on
other shapes, so the CPU's matmuls may round differently: bits are not
required against the unsharded forward.
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

import _torch_seq_worker as worker
from _torch_parity import randomize_params
from streamflow_tpu.config import StreamFlowConfig as JaxConfig
from streamflow_tpu.models import create_model as jax_create
from streamflow_tpu_torch import parallel
from streamflow_tpu_torch.config import StreamFlowConfig
from streamflow_tpu_torch.models import create_model
from streamflow_tpu_torch.params import load_jax
from streamflow_tpu_torch.parallel.exchange import Rows, even_split
from streamflow_tpu_torch.parallel.seq import encoder_unit, seq_plan
from streamflow_tpu_torch.training.checkpoint import save_params_npz

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (group, case, iters) of every sharded run
RUNS = [(g, case, it) for g, cases in worker.GROUPS.items()
        for case, spec in cases.items() for it in spec[4]]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def _variables(seed=1):
    """Fan-in-scaled random JAX variables from the init's shapes (nothing
    compiled)."""
    jm = jax_create("streamflow", cfg=JaxConfig(T=worker.T, iters=1,
                                                mixed_precision=False))
    shapes = jax.eval_shape(lambda k, a: jm.init(k, a, test_mode=True),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, worker.T, 64, 64, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    return {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        randomize_params(zeros["params"], seed))}


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


def _jax_flows(variables, dw, imgs, iters):
    """JAX's unsharded test-mode forward, one clip at a time (the rows of
    a batch are independent; one compile serves B=1 and B=2)."""
    jm = jax_create("streamflow", cfg=JaxConfig(
        T=worker.T, iters=iters, mixed_precision=False, dw_impl=dw))
    fn = jax.jit(lambda p, x: jm.apply(p, x, iters=iters, test_mode=True))
    return np.concatenate([np.asarray(fn(variables, jnp.asarray(c[None])))
                           for c in imgs])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group's ranks started at once, then JAX's and the port's
    unsharded forwards of each case computed while they run."""
    out = tmp_path_factory.mktemp("seq")
    variables = _variables()
    save_params_npz(str(out / "params.npz"), variables)
    procs = {g: _spawn(g, out) for g in worker.GROUPS}
    jax_ref, port_ref = {}, {}
    try:
        for g, case, it in RUNS:
            dw, h, w, b = worker.GROUPS[g][case][:4]
            imgs = worker.clip(h, w, b)
            jax_ref[case, it] = _jax_flows(variables, dw, imgs, it)
            model = worker.port_model(dw, str(out))
            port_ref[case, it] = model(torch.from_numpy(imgs), iters=it,
                                       test_mode=True).numpy()
    finally:
        done = {g: _wait(p, timeout=600) for g, p in procs.items()}
    for g, results in done.items():
        for rc, err in results:
            assert rc == 0, f"{g}: {err}"
    recs = {g: [json.loads((out / f"{g}_{r}.json").read_text())
                for r in range(worker.WORLD[g])] for g in worker.GROUPS}
    return SimpleNamespace(out=out, jax=jax_ref, port=port_ref, recs=recs)


def _rank_flows(runs, group, case, it):
    """Each rank's flows, and the rows of the batch it holds."""
    n_data, n_seq = worker.GROUPS[group][case][5:]
    b = worker.GROUPS[group][case][3] // n_data
    flows = []
    for r in range(worker.WORLD[group]):
        d = r // n_seq
        flows.append((np.load(runs.out / f"{case}_{it}_{r}.npy"),
                      slice(d * b, (d + 1) * b)))
    return flows


@pytest.mark.parametrize("group,case,it", RUNS)
def test_seq_sharded_matches_port_unsharded(runs, group, case, it):
    for got, rows in _rank_flows(runs, group, case, it):
        want = runs.port[case, it][rows]
        assert got.shape == want.shape and got.dtype == np.float32
        _close(got, want)


@pytest.mark.parametrize("group,case,it", RUNS)
def test_seq_sharded_matches_jax(runs, group, case, it):
    for got, rows in _rank_flows(runs, group, case, it):
        _close(got, runs.jax[case, it][rows])


@pytest.mark.parametrize("group,case,it", RUNS)
def test_seq_group_ranks_agree_bit_for_bit(runs, group, case, it):
    """The ranks of a seq group return the same whole flows."""
    n_seq = worker.GROUPS[group][case][6]
    flows = _rank_flows(runs, group, case, it)
    for r, (got, _) in enumerate(flows):
        first = flows[r - r % n_seq][0]
        assert np.array_equal(got.view(np.uint32), first.view(np.uint32))


def test_mesh_places_ranks_on_the_grid(runs):
    """rank = d * n_seq + s, JAX's devices.reshape(n_data, n_seq)."""
    assert [r["mesh"] for r in runs.recs["grid"]] == [[0, 0], [0, 1],
                                                      [1, 0], [1, 1]]
    assert [r["mesh"] for r in runs.recs["three"]] == [[0, 0], [0, 1],
                                                       [0, 2]]


def test_exchanges_keep_every_bit_pattern(runs):
    assert all(r["exchanges_exact"] for r in runs.recs["two"])


def test_data_group_of_one_seq_rank_is_bit_for_bit(runs):
    """make_mesh(n_data=2): each rank's seq group is itself; its rows of
    the batch equal model.forward's bit for bit."""
    assert all(r["solo_bit_for_bit"] for r in runs.recs["two"])


def test_mesh_and_batch_refusals_across_ranks(runs):
    assert all(r["bad_world_refused"] for r in runs.recs["two"])
    assert all(r["odd_batch_refused"] for r in runs.recs["grid"])


@pytest.mark.parametrize("dw_impl", ["auto", "pallas"])
def test_one_process_is_the_unsharded_forward_bit_for_bit(dw_impl):
    """A seq group of one (a single process, mesh None) runs the sharded
    code with no exchange: model.forward bit for bit."""
    model = create_model("streamflow", cfg=StreamFlowConfig(
        T=4, iters=2, mixed_precision=False, dw_impl=dw_impl), device="cpu")
    load_jax(model, _variables(2))
    imgs = torch.from_numpy(worker.clip(112, 64, 1))
    got = parallel.make_seq_sharded_forward(model, parallel.make_mesh())(
        imgs)
    assert torch.equal(got, model(imgs, test_mode=True))


@pytest.mark.parametrize("t,h,w,n,fnet,cnet,dec", [
    # the inference cell's 440x1024 clip over two ranks
    (4, 440, 1024, 2, [(0, 112), (112, 220)], [(0, 84), (84, 165)],
     [(0, 28), (28, 55)]),
    (4, 112, 128, 2, [(0, 28), (28, 56)], [(0, 28), (28, 42)],
     [(0, 7), (7, 14)]),
    (4, 168, 128, 3, [(0, 28), (28, 56), (56, 84)],
     [(0, 28), (28, 56), (56, 63)], [(0, 7), (7, 14), (14, 21)]),
    # 1440x2560: 26 and 20 units of 28 rows
    (4, 1440, 2560, 2, [(0, 364), (364, 720)], [(0, 280), (280, 540)],
     [(0, 90), (90, 180)]),
    (3, 400, 720, 4, [(0, 56), (56, 112), (112, 140), (140, 150)],
     [(0, 28), (28, 56), (56, 84), (84, 100)],
     [(0, 13), (13, 26), (26, 38), (38, 50)]),
    (4, 64, 64, 1, [(0, 32)], [(0, 24)], [(0, 8)]),
])
def test_seq_plan_boundaries(t, h, w, n, fnet, cnet, dec):
    plan = seq_plan(t, h, w, n)
    assert plan == (fnet, cnet, dec)
    unit = encoder_unit()
    for bounds, frames in ((plan.fnet, t), (plan.cnet, t - 1)):
        assert bounds[-1][1] == frames * h // 8
        assert all(a % unit == 0 for a, _ in bounds)


def test_encoder_unit_and_even_split():
    assert encoder_unit() == 28   # lcm(ws 7, sr 4); stage 1: lcm(7, 8) / 2
    assert even_split(55, 2) == [(0, 28), (28, 55)]
    assert even_split(7, 3) == [(0, 3), (3, 5), (5, 7)]


@pytest.mark.parametrize("args,match", [
    ((4, 100, 128, 2), "multiple of 8"),
    ((4, 112, 60, 2), "multiple of 8"),
    ((1, 112, 128, 2), "two frames"),
    ((4, 104, 128, 2), "thinner than the 7-row halo"),   # 13 rows: 7/6
    ((4, 224, 128, 5), "thinner than the 7-row halo"),
    ((2, 224, 128, 2), "fewer than n_seq=2"),             # cnet: 28 rows
    ((4, 168, 128, 4), "thinner"),
])
def test_seq_plan_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        seq_plan(*args)


def test_rows_refusals():
    with pytest.raises(ValueError, match="contiguous"):
        Rows([(0, 3), (4, 6)], 0)
    with pytest.raises(ValueError, match="need a group"):
        Rows([(0, 3), (3, 6)], 0)
    one = Rows([(0, 5)], 0)
    x = torch.zeros(1, 5, 2)
    assert one.gather(x) is x and one.halo(x, 3) == (x, 0)
    with pytest.raises(ValueError, match="entries along"):
        one.gather(torch.zeros(1, 4, 2))


@pytest.mark.parametrize("name,fields,entry", [
    ("streamflow", {"encoder": "twins"}, "A10c"),
    ("streamflow", {"encoder": "twins_3dconv"}, "A10c"),
    ("streamflow", {"update_block": "sk_tam_v1"}, "A10c"),
    ("streamflow", {"update_block": "sk_tam_v3_noinit"}, "A10c"),
    ("streamflow", {"use_gma": False}, "A10c"),
    ("streamflow", {"encoder": "basic"}, "A10d"),
    ("streamflow", {"encoder": "res18_3d"}, "A10d"),
    ("streamflow", {"encoder": "umt", "decoder_dim": 768}, "A10e"),
    ("raft", {}, "A10f"),
])
def test_other_models_raise_naming_their_roadmap_entry(name, fields, entry):
    if name == "raft":
        model = create_model("raft", device="cpu", mixed_precision=False)
    else:
        model = create_model(name, cfg=StreamFlowConfig(
            T=4, mixed_precision=False, **fields), device="cpu")
    with pytest.raises(NotImplementedError, match=entry):
        parallel.make_seq_sharded_forward(model, None)


def test_make_mesh_seq_needs_a_group():
    """n_seq > 1 in a process without a group raises; no fallback to one
    process."""
    with pytest.raises(ValueError, match="needs a process group"):
        parallel.make_mesh(n_seq=2)
    with pytest.raises(ValueError):
        parallel.make_mesh(n_data=1, n_seq=0)


class _TwoSlabs(Rows):
    """Rank 0 of two slabs, in one process: the other rank's rows are
    zeros (a stand-in for the exchange, for what the layer decides)."""

    def __init__(self, bounds):
        self.bounds, self.index, self.group = bounds, 0, None
        self.start, self.stop = bounds[0]
        self.total = bounds[-1][1]

    def coarse(self, div):
        return _TwoSlabs([(a // div, b // div) for a, b in self.bounds])

    def gather(self, x, dim=1, unit=1):
        pad = list(x.shape)
        pad[dim] = (self.total - self.size) * unit
        return torch.cat([x, x.new_zeros(pad)], dim=dim)


def test_gsa_flash_follows_the_whole_grid(monkeypatch):
    """A slab of 8960 tokens of a 17920-token grid takes K3 (flash) as the
    whole grid does above GSA_FLASH_TOKENS: the launches stay the
    unsharded forward's."""
    from streamflow_tpu_torch.layers import twins

    calls = []
    flash = twins.flash_attention
    monkeypatch.setattr(twins, "flash_attention",
                        lambda *a: calls.append(a[0].shape) or flash(*a))
    gsa = twins.GlobalSubSampleAttn(128, 4, 8)
    x = torch.randn(1, 56 * 160, 128)
    out = gsa(x, (56, 160), rows=_TwoSlabs([(0, 56), (56, 112)]))
    assert out.shape == x.shape
    assert calls == [(1, 4, 56 * 160, 32)]
    gsa(x, (56, 160))                     # the slab alone is under it
    assert len(calls) == 1
