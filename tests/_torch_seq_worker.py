"""Worker process of the tests/test_torch_seq*.py files (not a test file):
one rank of a gloo group on the CPU, rendezvous through a file store.

    python tests/_torch_seq_worker.py GROUP RANK WORLD STORE OUT

For each case of GROUPS[GROUP]: the port's StreamFlow of the case's
config (f32) holding the JAX variables the parent wrote to
OUT/params_<config>.npz, ``make_seq_sharded_forward`` over
``make_mesh(n_data, n_seq)`` on the case's clip (``clip``), its flows in
OUT/<case>_<iters>_<rank>.npy. Then OUT/<group>_<rank>.json records
each case's mesh place (d, s); for the "two" group a data group of one
seq rank each (``make_mesh(n_data=2)``) against ``model.forward`` on the
rank's rows bit for bit, the exchanges' bit patterns (bf16 and f32,
-0.0 and NaN included) and make_mesh's refusal of a world of another
size; for "eight" the exchanges on thin and empty slabs; for "eight" and
"three" each exchange's bytes against ``traffic`` (``exchange_record``);
for "cnn" the RAFT CNN's convs and InstanceNorm on thin and empty slabs
against the whole layer (``slab_layers``). Every case's last forward
runs under ``exchange.recording`` with ``dist.all_reduce`` counted
(``forward_record``).
"""

import json
import os
import sys
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 4


class Case(NamedTuple):
    """A sharded run: the config's fields beyond the canonical ones (f32,
    T=4), the clip (H, W, batch B), its iteration counts and the mesh."""
    fields: dict
    h: int
    w: int
    b: int
    iters: tuple
    n_data: int
    n_seq: int


FRAMES = ("twins", "twins_1dconv", "twins_temporal_attention",
          "twins_3dconv")
CNN = ("basic", "res18_3d")
UMT = {"encoder": "umt", "decoder_dim": 768}
DECODERS = {"sk_tam_v1": {"update_block": "sk_tam_v1"},
            "sk_tam_v3_noinit": {"update_block": "sk_tam_v3_noinit"},
            "no_gma": {"use_gma": False}}
# group -> case -> Case; a group's cases run one after the other
GROUPS = {
    # 112x128: decoder 7/7, fnet 28/28, cnet 28/14 stage-2 rows
    "two": {"auto": Case({}, 112, 128, 1, (1, 2), 1, 2),
            "pallas": Case({"dw_impl": "pallas"}, 112, 128, 1, (1,), 1, 2)},
    # 168x128: 7/7/7, a rank with two neighbours
    "three": {"three": Case({}, 168, 128, 1, (1,), 1, 3)},
    # 2 x 2; then B=1 over n_data=2: data group 1 holds no rows
    "grid": {"grid": Case({}, 112, 128, 2, (1,), 2, 2),
             "odd_batch": Case({}, 112, 128, 1, (1,), 2, 2)},
    # 48x64 (a 6-row 1/8 grid; fnet 24 and cnet 18 stacked rows, one
    # encoder unit): JAX's own case (tests/test_training_infra.py:
    # 322-341, B=1 over make_mesh(n_data=4, n_seq=2)), decoder 3/3; then
    # n_seq=8 (decoder 1,1,1,1,1,1,0,0, seven empty encoder slabs); then
    # B=3 over n_data=2 at n_seq=4 (decoder 2/2/1/1: halos past the
    # neighbour; data groups of 2 and 1 rows)
    "eight": {"jax_mesh": Case({}, 48, 64, 1, (1,), 4, 2),
              "empty": Case({}, 48, 64, 1, (1,), 1, 8),
              "thin": Case({}, 48, 64, 3, (1,), 2, 4)},
    # the per-frame encoders at 232x64: 29 rows a frame, two units, so
    # encoder slabs of 28 and 1 rows (every frame alike), decoder 15/14
    "frames": {name: Case({"encoder": name}, 232, 64, 1, (1,), 1, 2)
               for name in FRAMES},
    # one of them at n_seq=3: encoder slabs 28/1/0, decoder 10/10/9
    "frames3": {"twins_temporal_attention_3": Case(
        {"encoder": "twins_temporal_attention"}, 232, 64, 1, (1,), 1, 3)},
    # the decoder ablations on Twins_CSC at 112x128 (as "two")
    "decoders": {name: Case(fields, 112, 128, 1, (1,), 1, 2)
                 for name, fields in DECODERS.items()},
    # the CNN encoders at 48x64: a 6-row 1/8 grid split as the decoder's
    # (3/3; 2/2/1/1; six of 1 and two empty), the input's slabs 8 times
    # those rows; B=1 over make_mesh(n_data=4, n_seq=2), (2, 4), (1, 8)
    "cnn": {f"{name}_{n_seq}": Case({"encoder": name}, 48, 64, 1, (1,),
                                    8 // n_seq, n_seq)
            for name in CNN for n_seq in (2, 4, 8)},
    # B=3 over make_mesh(n_data=2, n_seq=2): data groups of 2 and 1 rows
    "cnn_grid": {f"{name}_grid": Case({"encoder": name}, 48, 64, 3, (1,),
                                      2, 2) for name in CNN},
    # UMT (decoder_dim=768) at 64x128: a 4-row 1/16 grid, B=1 over
    # make_mesh(n_data=3, n_seq=2) (2/2), (2, 3) (2/1/1) and (1, 6)
    # (1/1/1/1 and two empty slabs)
    "umt": {f"umt_{n_seq}": Case(UMT, 64, 128, 1, (1,), 6 // n_seq, n_seq)
            for n_seq in (2, 3, 6)},
}
WORLD = {g: max(c.n_data * c.n_seq for c in cases.values())
         for g, cases in GROUPS.items()}


def config_name(fields) -> str:
    """The file stem of a config's variables: its fields, sorted."""
    return "_".join(f"{k}-{v}" for k, v in sorted(fields.items())
                    if k != "dw_impl") or "canonical"


def clip(h, w, b, seed=5):
    """The seeded clip of a case: (B, T, H, W, 3) integers in [0, 255)."""
    import numpy as np

    return np.random.default_rng(seed + h + b).integers(
        0, 255, (b, T, h, w, 3)).astype(np.float32)


def port_model(fields, out):
    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.params import load_jax
    from streamflow_tpu_torch.training.checkpoint import load_params_npz

    model = create_model("streamflow", cfg=StreamFlowConfig(
        T=T, iters=1, mixed_precision=False, **fields), device="cpu")
    load_jax(model, load_params_npz(os.path.join(
        out, f"params_{config_name(fields)}.npz")))
    return model


def exchanges_exact(rows):
    """Rows.gather and Rows.halo (k = 2 and 5) over the seq group of
    ``rows`` return every rank's bit patterns (bf16 and f32, -0.0, NaN
    and infinities included): the halo holds the grid's rows start - top
    to stop + bottom, cut only at its edges, and an empty slab gets
    none."""
    import torch

    ok = True
    for dt in (torch.bfloat16, torch.float32):
        whole = torch.randn(2, rows.total, 5, generator=torch.Generator(
            ).manual_seed(1)).to(dt)
        whole[0, 0, :4] = torch.tensor([-0.0, float("nan"), float("inf"),
                                        -float("inf")]).to(dt)
        whole[1, -1, 0] = -0.0
        mine = whole[:, rows.start:rows.stop]
        got = rows.gather(mine, 1)
        ok &= got.view(torch.uint8).equal(whole.view(torch.uint8))
        for k in (2, 5):
            ext, top = rows.halo(mine, k, dim=1)
            a = rows.start - top
            b = a + ext.shape[1]
            ok &= ext.view(torch.uint8).equal(
                whole[:, a:b].contiguous().view(torch.uint8))
            if rows.size:
                ok &= top == min(k, rows.start) and b == min(rows.stop + k,
                                                             rows.total)
            else:
                ok &= top == 0 and ext.shape[1] == 0
    return bool(ok)


def _bounds(sizes):
    return [(sum(sizes[:r]), sum(sizes[:r + 1])) for r in range(len(sizes))]


def _counting_all_reduce(calls):
    """(torch.distributed.all_reduce, a stand-in that counts its calls
    into ``calls`` and calls it)."""
    import torch.distributed as dist

    inner = dist.all_reduce

    def counted(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)
    return inner, counted


def summarize(rec, calls):
    """A record of exchanges: their kinds in order, whether every one's
    bytes sent and received are ``traffic``'s, the all_reduce calls made
    (``calls``), and the bytes sent, received and of the all_reduce
    form."""
    plans = [e.planned() for e in rec]
    return {"kinds": [e.kind for e in rec],
            "planned": all((e.sent, e.received) == (p.sent, p.received)
                           for e, p in zip(rec, plans)),
            "all_reduces": len(calls),
            "sent": sum(e.sent for e in rec),
            "received": sum(e.received for e in rec),
            "old": sum(p.old for p in plans)}


def recorded(fn):
    """``fn()`` under ``exchange.recording``, every ``dist.all_reduce``
    call counted; returns (its result, ``summarize``'s record, the
    record)."""
    import torch.distributed as dist

    from streamflow_tpu_torch.parallel import exchange

    calls = []
    inner, dist.all_reduce = _counting_all_reduce(calls)
    try:
        with exchange.recording() as rec:
            out = fn()
    finally:
        dist.all_reduce = inner
    return out, summarize(rec, calls), rec


def exchange_record(rows):
    """Rows.halo at k = 1, 3 and 7, Rows.gather (unit 1 along dim 1, unit 2
    along dim 2) and Rows.sum over the seq group of ``rows``, recorded:
    whether each halo holds the grid's rows start - top to stop + bottom
    (none on an empty slab) and each gather the whole grid, bit for bit,
    and each exchange's bytes sent and received, the record's beside
    ``traffic``'s."""
    import torch

    gen = torch.Generator().manual_seed(4)
    whole = torch.randn(2, rows.total, 6, generator=gen)
    mine = whole[:, rows.start:rows.stop]
    wide = torch.randn(3, 4, 2 * rows.total, generator=gen).to(
        torch.bfloat16)

    def exchanges():
        halos = []
        for k in (1, 3, 7):
            ext, top = rows.halo(mine, k)
            a = rows.start - top
            halos.append(bool(ext.equal(
                whole[:, a:min(rows.stop + k, rows.total)]
                if rows.size else mine)))
        gathers = [bool(rows.gather(mine, 1).equal(whole)), bool(
            rows.gather(wide[:, :, 2 * rows.start:2 * rows.stop], 2,
                        unit=2).view(torch.int16).equal(
                            wide.view(torch.int16)))]
        rows.sum(mine.sum((1, 2)))
        return halos, gathers
    (halos, gathers), summary, rec = recorded(exchanges)
    return {"halos": halos, "gathers": gathers,
            "bytes": [[e.kind, e.sent, e.received, *e.planned()[:2]]
                      for e in rec], **summary}


# slab_layers: the RAFT CNN's conv kinds (c_in, c_out, k, stride,
# padding) on slabs of SLAB_ROWS input rows (a world of 8: thin ones,
# thinner than the stem's 3-row halo, and empty ones)
SLAB_CONVS = {"stem_7x7_s2_p3": (3, 16, 7, 2, 3),
              "3x3_s1_p1": (8, 16, 3, 1, 1),
              "3x3_s2_p1": (8, 16, 3, 2, 1),
              "downsample_1x1_s2": (8, 16, 1, 2, 0)}
SLAB_ROWS = [6, 2, 0, 2, 4, 0, 34, 0]
# the exchanges' own checks: slabs of the worlds of 8 ("eight") and 3
EIGHT_ROWS = [3, 1, 0, 2, 1, 0, 4, 0]
THREE_ROWS = [5, 1, 2]


def slab_layers(rows):
    """Each of SLAB_CONVS through ``conv2d_rows`` and InstanceNorm through
    ``instance_norm(rows=...)`` on this rank's slab ``rows`` of a (2, 48,
    20, C) grid, against the whole layer's rows of the slab (the conv's
    output rows start // stride to stop // stride): label -> [shapes
    equal, max abs difference]."""
    import torch

    from streamflow_tpu_torch.layers.common import (conv2d, conv2d_rows,
                                                    instance_norm)

    def compare(got, want):
        err = float((got - want).abs().max()) if got.numel() else 0.0
        return [got.shape == want.shape, err]

    torch.manual_seed(3)          # the same weights and grids on every rank
    out = {}
    for label, (c_in, c_out, k, s, p) in SLAB_CONVS.items():
        conv = torch.nn.Conv2d(c_in, c_out, k, s, p)
        x = torch.randn(2, rows.total, 20, c_in)
        got = conv2d_rows(x[:, rows.start:rows.stop], conv, rows)
        want = conv2d(x, conv)[:, rows.start // s:rows.stop // s]
        out[label] = compare(got, want)
    x = 3.0 + torch.randn(2, rows.total, 20, 16)
    got = instance_norm(x[:, rows.start:rows.stop], rows=rows)
    want = instance_norm(x)[:, rows.start:rows.stop]
    out["instance_norm"] = compare(got, want)
    return out


def main():
    group, rank, world, store, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from streamflow_tpu_torch import parallel
    from streamflow_tpu_torch.parallel.exchange import Rows
    from streamflow_tpu_torch.parallel.multihost import shutdown

    assert parallel.initialize(f"file://{store}", world, rank,
                               device="cpu") == (rank, world)
    rec = {"mesh": {}, "forward": {}}
    for case, c in GROUPS[group].items():
        model = port_model(c.fields, out)
        mesh = parallel.make_mesh(c.n_data, c.n_seq)
        rec["mesh"][case] = [mesh.d, mesh.s]
        imgs = torch.from_numpy(clip(c.h, c.w, c.b))
        for it in c.iters:
            fwd = parallel.make_seq_sharded_forward(model, mesh, it)
            flows, rec["forward"][case], _ = recorded(lambda: fwd(imgs))
            np.save(os.path.join(out, f"{case}_{it}_{rank}.npy"),
                    flows.numpy())
    if group == "two":
        n, s = mesh.n_seq, mesh.s
        rec["exchanges_exact"] = exchanges_exact(Rows(
            [(3 * r + min(r, 1), 3 * (r + 1) + 1) for r in range(n)], s,
            mesh.seq_group))
        try:
            parallel.make_mesh(n_data=2, n_seq=2)
            rec["bad_world_refused"] = False
        except ValueError:
            rec["bad_world_refused"] = True
        # a seq group of one: each rank's data rows whole
        model = port_model({}, out)
        imgs = torch.from_numpy(clip(112, 128, 2))
        fwd = parallel.make_seq_sharded_forward(
            model, parallel.make_mesh(n_data=2), 2)
        got = fwd(imgs)
        want = model(imgs[rank:rank + 1], iters=2, test_mode=True)
        rec["solo_bit_for_bit"] = bool(torch.equal(got, want))
    if group == "cnn":
        mesh = parallel.make_mesh(n_seq=world)
        rec["slab_layers"] = slab_layers(Rows(_bounds(SLAB_ROWS), mesh.s,
                                              mesh.seq_group))
    if group == "eight":
        # thin slabs (1 row) between empty ones, halos of 2 and 5 rows
        # reaching past the neighbours, over the whole world of 8
        mesh = parallel.make_mesh(n_seq=world)
        rows = Rows(_bounds(EIGHT_ROWS), mesh.s, mesh.seq_group)
        rec["exchanges_exact"] = exchanges_exact(rows)
        rec["exchange_record"] = exchange_record(rows)
    if group == "three":
        # an uneven split: a 1-row slab between two, halos of 3 and 7
        # rows reaching across it
        mesh = parallel.make_mesh(n_seq=world)
        rec["exchange_record"] = exchange_record(
            Rows(_bounds(THREE_ROWS), mesh.s, mesh.seq_group))
    with open(os.path.join(out, f"{group}_{rank}.json"), "w") as fh:
        json.dump(rec, fh)
    shutdown()


if __name__ == "__main__":
    main()
