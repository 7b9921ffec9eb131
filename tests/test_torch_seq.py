"""The port's sequence-sharded forward (streamflow_tpu_torch/parallel/
seq.py, exchange.py; JAX's parallel/seq.py::make_seq_sharded_forward) on
the CPU, through tests/_torch_seq.py's harness: gloo ranks against the
port's unsharded forward and JAX's, f32.

(i)   n_seq=2 at 112x128, T=4, iters 1 and 2 (decoder slabs 7/7, fnet
      28/28, cnet 28/14 stage-2 rows);
(ii)  n_seq=3 at 168x128, iters 1 (7/7/7: a rank with two neighbours);
(iii) n_data=2 x n_seq=2, B=2, at 112x128, iters 1; then B=1 over the
      same mesh (data group 1 holds no rows);
(iv)  dw_impl='pallas' at n_seq=2, iters 1;
(v)   a seq group of one (one process, every StreamFlow; and
      make_mesh(n_data=2)'s data group of two) bit for bit with
      ``model.forward``;
(vi)  the slab planner's boundaries, thin and empty slabs included, for
      the Twins, CNN and UMT encoders;
(vii) the ValueErrors and NotImplementedErrors;
(viii) GSA's flash switch on a slab follows the whole grid's tokens;
(ix)  the kernel wrappers on no rows launch nothing;
(x)   the exchanges' forms: every forward's exchanges, recorded, follow
      ``exchange.traffic`` (halos by point-to-point sends, gathers by
      all_gather, an all_reduce for sums alone); halos of 1, 3 and 7 rows
      and gathers on slabs of 5, 1, 2 rows; ``traffic`` against the
      all_reduce form; the form follows the group's backend.

The thin and empty slabs at 48x64 (JAX's own case) are in
test_torch_seq_thin.py, the per-frame encoders in
test_torch_seq_frames.py, the decoder ablations in
test_torch_seq_decoders.py, the CNN encoders in test_torch_seq_cnn.py,
UMT in test_torch_seq_umt.py.
"""

import pytest
import torch

import _torch_seq as seq
import _torch_seq_worker as worker
from streamflow_tpu_torch import parallel
from streamflow_tpu_torch.config import StreamFlowConfig
from streamflow_tpu_torch.models import create_model
from streamflow_tpu_torch.params import load_jax
from streamflow_tpu_torch.parallel.exchange import (Rows, even_split,
                                                   traffic)
from streamflow_tpu_torch.parallel.seq import (SeqPlan, encoder_kind,
                                               encoder_unit, seq_plan)

torch.set_num_threads(2)
GROUPS = ("two", "three", "grid")
RUNS = seq.runs_of(GROUPS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return seq.start(GROUPS, tmp_path_factory.mktemp("seq"))


(test_seq_sharded_matches_port_unsharded, test_seq_sharded_matches_jax,
 test_seq_group_ranks_agree_bit_for_bit) = seq.parity_tests(RUNS)
test_forward_exchanges_follow_the_plan = seq.record_tests(GROUPS)
(test_halos_and_gathers_match_the_whole_grid,
 test_exchange_bytes_follow_the_plan,
 test_no_exchange_goes_through_an_all_reduce) = seq.exchange_tests(
    "three", worker.THREE_ROWS)


def test_mesh_places_ranks_on_the_grid(runs):
    """rank = d * n_seq + s, JAX's devices.reshape(n_data, n_seq)."""
    assert [r["mesh"]["grid"] for r in runs.recs["grid"]] == [
        [0, 0], [0, 1], [1, 0], [1, 1]]
    assert [r["mesh"]["three"] for r in runs.recs["three"]] == [
        [0, 0], [0, 1], [0, 2]]


def test_exchanges_keep_every_bit_pattern(runs):
    assert all(r["exchanges_exact"] for r in runs.recs["two"])


def test_data_group_of_one_seq_rank_is_bit_for_bit(runs):
    """make_mesh(n_data=2): each rank's seq group is itself; its rows of
    the batch equal model.forward's bit for bit."""
    assert all(r["solo_bit_for_bit"] for r in runs.recs["two"])


def test_mesh_and_batch_refusals_across_ranks(runs):
    """A world of another size is refused; a batch that n_data does not
    divide is not: B=1 over n_data=2 gives data group 0 the clip and
    group 1 no rows, (0, T-1, H, W, 2)."""
    assert all(r["bad_world_refused"] for r in runs.recs["two"])
    shapes = [f.shape for f, _ in seq.rank_flows(runs, "grid", "odd_batch",
                                                 1)]
    assert shapes == [(1, 3, 112, 128, 2)] * 2 + [(0, 3, 112, 128, 2)] * 2


def _model(fields, seed=2, **kw):
    model = create_model("streamflow", cfg=StreamFlowConfig(
        T=4, iters=2, mixed_precision=False, **fields, **kw), device="cpu")
    load_jax(model, seq.variables(fields, seed))
    return model


@pytest.mark.parametrize("dw_impl", ["auto", "pallas"])
def test_one_process_is_the_unsharded_forward_bit_for_bit(dw_impl):
    """A seq group of one (a single process, mesh None) runs the sharded
    code with no exchange: model.forward bit for bit."""
    model = _model({}, dw_impl=dw_impl)
    imgs = torch.from_numpy(worker.clip(112, 64, 1))
    got = parallel.make_seq_sharded_forward(model, parallel.make_mesh())(
        imgs)
    assert torch.equal(got, model(imgs, test_mode=True))


@pytest.mark.parametrize("fields", [
    {"encoder": "twins"}, {"encoder": "twins_1dconv"},
    {"encoder": "twins_temporal_attention"}, {"encoder": "twins_3dconv"},
    {"update_block": "sk_tam_v1"}, {"update_block": "sk_tam_v3_noinit"},
    {"use_gma": False}, {"encoder": "basic"}, {"encoder": "res18_3d"},
    {"encoder": "umt", "decoder_dim": 768}],
    ids=lambda f: "-".join(map(str, f.values())))
def test_every_twins_model_is_sharded(fields):
    """The per-frame Twins encoders and the decoder ablations (refused
    until ROADMAP A10c), the CNN encoders (A10d) and UMT (A10e) run the
    sharded code: in one process, with no exchange, model.forward bit for
    bit (their gloo runs are test_torch_seq_frames.py's,
    test_torch_seq_decoders.py's, test_torch_seq_cnn.py's and
    test_torch_seq_umt.py's). The first forward of a CPU process may
    round its convs otherwise: one call first."""
    model = _model(fields)
    imgs = torch.from_numpy(worker.clip(48, 64, 1))
    model(imgs, iters=1, test_mode=True)
    got = parallel.make_seq_sharded_forward(model, None, 2)(imgs)
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
    # one 8-GPU node: decoder 7 x 7 + 6; the cnet's 6 units leave two
    # ranks empty
    (4, 440, 1024, 8, [(28 * i, min(28 * i + 28, 220)) for i in range(8)],
     [(28 * i, 28 * i + 28) for i in range(5)] + [(140, 165)] * 1
     + [(165, 165)] * 2, [(7 * i, min(7 * i + 7, 55)) for i in range(8)]),
    # JAX's test shape: one encoder unit, 6 decoder rows over 8
    (4, 48, 64, 8, [(0, 24)] + [(24, 24)] * 7, [(0, 18)] + [(18, 18)] * 7,
     [(i, i + 1) for i in range(6)] + [(6, 6)] * 2),
    (4, 48, 64, 4, [(0, 24)] + [(24, 24)] * 3, [(0, 18)] + [(18, 18)] * 3,
     [(0, 2), (2, 4), (4, 5), (5, 6)]),
])
def test_seq_plan_boundaries(t, h, w, n, fnet, cnet, dec):
    plan = seq_plan(t, h, w, n)
    assert plan == (fnet, cnet, dec)
    unit = encoder_unit()
    for bounds, frames in ((plan.fnet, t), (plan.cnet, t - 1)):
        assert bounds[-1][1] == frames * h // 8
        assert all(a % unit == 0 for a, b in bounds if b > a)
    assert [sum(plan.holds(s).values()) for s in range(n)] == [
        sum(b - a for a, b in (g[s] for g in plan)) for s in range(n)]


@pytest.mark.parametrize("t,h,w,n,frame,dec", [
    # 440x1024 per frame: 55 rows, two units; decoder 14/14/14/13
    (4, 440, 1024, 4, [(0, 28), (28, 55), (55, 55), (55, 55)],
     [(0, 14), (14, 28), (28, 42), (42, 55)]),
    (4, 232, 64, 2, [(0, 28), (28, 29)], [(0, 15), (15, 29)]),
    (4, 232, 64, 3, [(0, 28), (28, 29), (29, 29)],
     [(0, 10), (10, 20), (20, 29)]),
    (3, 1440, 2560, 2, [(0, 112), (112, 180)], [(0, 90), (90, 180)]),
])
def test_seq_plan_per_frame(t, h, w, n, frame, dec):
    """A per-frame encoder's slabs are the same rows of every frame, the
    fnet's and the cnet's alike."""
    plan = seq_plan(t, h, w, n, temporal=False)
    assert plan == (frame, frame, dec)
    assert plan.holds(n - 1) == {"fnet": frame[-1][1] - frame[-1][0],
                                 "cnet": frame[-1][1] - frame[-1][0],
                                 "decoder": dec[-1][1] - dec[-1][0]}


@pytest.mark.parametrize("encoder,t,h,w,n,rows", [
    # the CNN encoders: each frame's H/8 rows, as the decoder's
    ("basic", 4, 440, 1024, 4, [(0, 14), (14, 28), (28, 42), (42, 55)]),
    ("res18_3d", 4, 48, 64, 8, [(i, i + 1) for i in range(6)]
     + [(6, 6)] * 2),
    ("mf_basic", 3, 1440, 2560, 2, [(0, 90), (90, 180)]),
    # UMT: each frame's H/16 rows, the decoder's too
    ("umt", 4, 448, 1024, 4, [(0, 7), (7, 14), (14, 21), (21, 28)]),
    ("umt", 4, 64, 128, 3, [(0, 2), (2, 3), (3, 4)]),
    ("umt", 4, 64, 128, 6, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 4),
                            (4, 4)]),
])
def test_seq_plan_cnn_and_umt(encoder, t, h, w, n, rows):
    """The CNN encoders and UMT split their grids as the decoder does, with
    no encoder unit; an empty slab holds none of the three."""
    kind = encoder_kind(encoder)
    assert kind == ("umt" if encoder == "umt" else "cnn")
    plan = seq_plan(t, h, w, n, temporal=False, kind=kind)
    assert plan == (rows, rows, rows)
    assert [plan.holds(s) for s in range(n)] == [
        dict.fromkeys(("fnet", "cnet", "decoder"), b - a) for a, b in rows]


def test_encoder_unit_and_even_split():
    assert encoder_unit() == 28   # lcm(ws 7, sr 4); stage 1: lcm(7, 8) / 2
    assert even_split(55, 2) == [(0, 28), (28, 55)]
    assert even_split(7, 3) == [(0, 3), (3, 5), (5, 7)]


@pytest.mark.parametrize("args,match", [
    ((4, 100, 128, 2), "multiple of 8"),
    ((4, 112, 60, 2), "multiple of 8"),
    ((1, 112, 128, 2), "two frames"),
    ((4, 112, 128, 0), "n_seq=0"),
    ((4, 440, 1024, 2, False, "umt"), "440x1024 is not a multiple of 16"),
    ((4, 448, 1000, 2, False, "umt"), "448x1000 is not a multiple of 16"),
    ((4, 100, 128, 2, False, "cnn"), "multiple of 8"),
])
def test_seq_plan_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        seq_plan(*args)


@pytest.mark.parametrize("args,plan", [
    # refused until the halo read past the neighbour: 13 rows, 7/6
    ((4, 104, 128, 2), ([(0, 28), (28, 52)], [(0, 28), (28, 39)],
                        [(0, 7), (7, 13)])),
    # 28 rows in 5: 6,6,6,5,5; fnet 4 units, cnet 3: empty encoder slabs
    ((4, 224, 128, 5), ([(0, 28), (28, 56), (56, 84), (84, 112),
                         (112, 112)],
                        [(0, 28), (28, 56), (56, 84), (84, 84), (84, 84)],
                        [(0, 6), (6, 12), (12, 18), (18, 23), (23, 28)])),
    # refused for fewer units than ranks: the cnet's 28 rows, one unit
    ((2, 224, 128, 2), ([(0, 28), (28, 56)], [(0, 28), (28, 28)],
                        [(0, 14), (14, 28)])),
    ((4, 168, 128, 4), ([(0, 28), (28, 56), (56, 84), (84, 84)],
                        [(0, 28), (28, 56), (56, 63), (63, 63)],
                        [(0, 6), (6, 11), (11, 16), (16, 21)])),
])
def test_seq_plan_thin_and_empty_slabs(args, plan):
    """The shapes refused for a slab thinner than the halo or fewer units
    than ranks (until ROADMAP A10h) have a plan: thin slabs, and empty
    ones past the last unit."""
    got = seq_plan(*args)
    assert isinstance(got, SeqPlan) and got == plan
    empty = [s for s in range(args[3]) if not got.holds(s)["cnet"]]
    assert empty == [s for s, (a, b) in enumerate(plan[1]) if a == b]


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
    ("raft", {}, "A10f"),
])
def test_other_models_raise_naming_their_roadmap_entry(name, fields, entry):
    """Only the two-frame models are refused (the CNN encoders and UMT,
    refused until A10d and A10e, run: test_every_twins_model_is_sharded)."""
    model = create_model(name, device="cpu", mixed_precision=False, **fields)
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


@pytest.mark.parametrize("size,flash", [((56, 256), True), ((28, 128), False)])
def test_gsa_flash_per_frame_follows_one_frame(monkeypatch, size, flash):
    """A per-frame encoder's GSA on a slab of each of 4 frames of 440x1024
    takes K3 by one frame's whole token count: stage 1 (110 x 256 = 28160
    tokens) does, stage 2 (55 x 128 = 7040) does not."""
    from streamflow_tpu_torch.layers import twins

    calls = []
    flash_fn = twins.flash_attention
    monkeypatch.setattr(twins, "flash_attention",
                        lambda *a: calls.append(a[0].shape) or flash_fn(*a))
    rows, w = size
    dim, sr = (128, 8) if flash else (256, 4)
    gsa = twins.GlobalSubSampleAttn(dim, dim // 32, sr)
    x = torch.randn(4, rows * w, dim)
    out = gsa(x, (rows, w), rows=_TwoSlabs([(0, rows), (rows, 2 * rows - 1)]))
    assert out.shape == x.shape and len(calls) == int(flash)


class _Card(torch.Tensor):
    """A CPU tensor that passes for one on the card (is_cuda), so that a
    wrapper takes its kernel path."""

    @property
    def is_cuda(self):
        return True


def test_no_rows_launch_no_kernel(monkeypatch):
    """K1, K2 (both its fused and wide plans), K3 and K4 on an empty slab's
    no rows, on the card's path: outputs of no rows, no launcher called,
    no launch counted (a CUDA launch over an empty grid is an invalid
    configuration)."""
    from streamflow_tpu_torch import _build
    from streamflow_tpu_torch.ops.kernels import (LAUNCHES, corr_lookup,
                                                  ffn_pair, flash_attention,
                                                  lga_attention)

    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *a: calls.append(name) or 0
    monkeypatch.setattr(_build, "library", Lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 7)
    before = dict(LAUNCHES)

    def card(*shape):
        return torch.zeros(*shape, dtype=torch.bfloat16).as_subclass(_Card)
    f1 = card(3, 0, 16, 256)
    levels = [card(3, 8 >> i, 16 >> i, 256) for i in range(4)]
    coords = torch.zeros(3, 0, 16, 2).as_subclass(_Card)
    assert corr_lookup.corr_lookup(f1, levels, coords).shape == (3, 0, 16,
                                                                 324)
    for c, ch, co in ((324, 486, 256), (1920, 2880, 384)):
        x = card(3, 0, 16, c)
        out = ffn_pair.ffn_pair_k1(x, card(ch, c), card(ch), card(co, ch),
                                   card(co), card(co), card(co))
        assert out.shape == (3, 0, 16, co)
        out = ffn_pair.ln_ffn_pair(card(4, 0, c), card(c), card(c),
                                   card(ch, c), card(ch), card(c, ch),
                                   card(c))
        assert out.shape == (4, 0, c)
    q = card(3, 1, 0, 128)
    kv = card(3, 1, 77, 128)
    out, lse = flash_attention.flash_attention_fwd(q, kv, kv, True)
    assert out.shape == q.shape and lse.shape == (3, 1, 0)
    assert flash_attention.flash_attention(q, kv, kv).shape == q.shape
    assert lga_attention.lga_attention(card(4, 0, 259, 384), 7, 4).shape == (
        4, 0, 259, 128)
    assert calls == [] and LAUNCHES == before


def test_layers_on_no_rows():
    """The layers an empty slab reaches: the kxk convs (``conv2d``: no
    call) and each SK block layout return no rows of their output's
    width."""
    from streamflow_tpu_torch.layers.common import conv2d
    from streamflow_tpu_torch.layers.sk import SKBlock

    x = torch.zeros(3, 0, 16, 64)
    for conv, width in ((torch.nn.Conv2d(64, 64, 3, padding=1, groups=64),
                         16), (torch.nn.Conv2d(64, 32, 4, stride=4), 4),
                        (torch.nn.Conv2d(64, 64, 8, stride=8), 2)):
        assert conv2d(x, conv).shape == (3, 0, width, conv.out_channels)
    for dw in ("auto", "pallas", "banded_mxu", "banded_chain"):
        assert SKBlock(64, 6, (1, 15), dw)(x).shape == (3, 0, 16, 6)


def test_halo_reach_reads_past_the_neighbours():
    """The rows halo's buffer carries: k rows above and below each
    non-empty slab, merged, within the grid; the empty slabs read none."""
    rows = Rows([(0, 3), (3, 4), (4, 4), (4, 6), (6, 7), (7, 7), (7, 11),
                 (11, 11)], 0, group=object())
    assert rows.reach(2) == [(1, 9)] and rows.reach(1) == [(2, 8)]
    assert Rows([(0, 28), (28, 55)], 1, group=object()).reach(7) == [
        (21, 35)]
    assert Rows([(0, 10), (10, 20), (20, 30)], 2, group=object()).reach(
        2) == [(8, 12), (18, 22)]


def test_traffic_prices_both_forms():
    """``traffic`` at the canonical 1/8 grid of 55 rows, R bytes a row:
    n_seq=2, a 15x15 conv's 7-row halo sends and receives 7 rows, where
    the all_reduce form's buffer held the 14 rows that either halo reads
    (2(n-1)/n = 1 of it); the gather sends and receives the other slab's
    28-row chunk, against the whole 55-row buffer. n_seq=8 (seven of 7
    rows, one of 6): a middle rank's halo moves 7 rows each way against
    2(7)/8 of 49 reached rows."""
    r = 1000
    two = even_split(55, 2)
    assert traffic("halo", two, 0, r, 7) == (7 * r, 7 * r, 14 * r)
    assert traffic("gather", two, 1, r) == (28 * r, 28 * r, 55 * r)
    assert traffic("sum", two, 0, 8) == (8.0, 8.0, 8.0)
    eight = even_split(55, 8)
    assert traffic("halo", eight, 3, r, 7) == (14 * r, 14 * r,
                                               2 * 7 * 55 * r / 8)
    assert traffic("halo", eight, 0, r, 7) == (7 * r, 7 * r,
                                               2 * 7 * 55 * r / 8)
    # an empty slab sends and receives nothing, and joined the all_reduce
    assert traffic("halo", [(0, 3), (3, 3), (3, 5)], 1, r, 2) == (
        0, 0, 2 * 2 * 4 * r / 3)
    # the buffer was whole int32 words
    assert traffic("gather", two, 0, 2).old == 112


class _Group:
    """A stand-in for a process group, of the backend ``name``."""

    def __init__(self, name):
        self.name = name


def test_exchange_form_follows_the_backend(monkeypatch):
    """Gloo: CPU tensors as they are, CUDA tensors staged through the
    host; NCCL: CUDA tensors as they are, CPU tensors refused; another
    backend refused: no form is tried after another."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_backend", lambda g: g.name)
    cpu = torch.zeros(2)
    card = cpu.as_subclass(_Card)
    rows = {b: Rows([(0, 1), (1, 2)], 0, _Group(b))
            for b in ("gloo", "nccl", "mpi")}
    assert rows["gloo"]._staged(cpu) is False
    assert rows["gloo"]._staged(card) is True
    assert rows["nccl"]._staged(card) is False
    for backend, x in (("nccl", cpu), ("mpi", cpu), ("mpi", card)):
        with pytest.raises(ValueError, match=f"over {backend}"):
            rows[backend]._staged(x)


def test_seq_traffic_prices_records_at_the_width():
    """tools/seq_traffic.py: a record priced by ``traffic`` with a halo's
    and a gather's row bytes times the width's ratio, a sum's as it is;
    a record whose own bytes are not its plan's raises."""
    from streamflow_tpu_torch.parallel.exchange import Exchange
    from streamflow_tpu_torch.tools.seq_traffic import priced

    two = tuple(even_split(55, 2))
    recs = [Exchange("halo", 700, 700, False, 0.0, two, 0, 100, 7),
            Exchange("gather", 2800, 2800, False, 0.0, two, 0, 100, 1),
            Exchange("sum", 8.0, 8.0, False, 0.0, two, 0, 8, 1)]
    assert priced(recs, 8) == {
        "halo": dict(n=1, sent=5600, received=5600, old=11200.0),
        "gather": dict(n=1, sent=22400, received=22400, old=44000.0),
        "sum": dict(n=1, sent=8.0, received=8.0, old=8.0)}
    with pytest.raises(AssertionError, match="plan"):
        priced([recs[0]._replace(sent=1)], 1)
