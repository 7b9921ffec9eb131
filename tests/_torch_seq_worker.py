"""Worker process of tests/test_torch_seq.py (not a test file): one rank of
a gloo group on the CPU, rendezvous through a file store.

    python tests/_torch_seq_worker.py GROUP RANK WORLD STORE OUT

For each case of GROUPS[GROUP]: the port's canonical StreamFlow (f32,
the case's ``dw_impl``) holding the JAX variables the parent wrote to
OUT/params.npz, ``make_seq_sharded_forward`` over
``make_mesh(n_data, n_seq)`` on the case's clip (``clip``), its flows in
OUT/<case>_<iters>_<rank>.npy. Then OUT/<group>_<rank>.json records:
the mesh's (d, s); for the "two" group a data group of one seq rank each
(``make_mesh(n_data=2)``) against ``model.forward`` on the rank's rows
bit for bit, the exchanges' bit patterns (bf16 and f32, -0.0 and NaN
included) and make_mesh's refusal of a world of another size; for
"grid" the refusal of a batch that n_data does not divide.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 4
# case -> (dw_impl, H, W, B, iterations, n_data, n_seq)
GROUPS = {
    "two": {"auto": ("auto", 112, 128, 1, (1, 2), 1, 2),
            "pallas": ("pallas", 112, 128, 1, (1,), 1, 2)},
    "three": {"three": ("auto", 168, 128, 1, (1,), 1, 3)},
    "grid": {"grid": ("auto", 112, 128, 2, (1,), 2, 2)},
}
WORLD = {"two": 2, "three": 3, "grid": 4}


def clip(h, w, b, seed=5):
    """The seeded clip of a case: (B, T, H, W, 3) integers in [0, 255)."""
    import numpy as np

    return np.random.default_rng(seed + h + b).integers(
        0, 255, (b, T, h, w, 3)).astype(np.float32)


def port_model(dw_impl, out):
    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.params import load_jax
    from streamflow_tpu_torch.training.checkpoint import load_params_npz

    model = create_model("streamflow", cfg=StreamFlowConfig(
        T=T, iters=1, mixed_precision=False, dw_impl=dw_impl), device="cpu")
    load_jax(model, load_params_npz(os.path.join(out, "params.npz")))
    return model


def exchanges_exact(mesh):
    """Rows.gather and Rows.halo over the seq group return every rank's
    bit patterns (bf16 and f32, -0.0, NaN and infinities included)."""
    import torch

    from streamflow_tpu_torch.parallel.exchange import Rows

    n, s = mesh.n_seq, mesh.s
    bounds = [(3 * r + min(r, 1), 3 * (r + 1) + 1) for r in range(n)]
    rows = Rows(bounds, s, mesh.seq_group)
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
        ext, top = rows.halo(mine, 2, dim=1)
        a, b = rows.start - top, rows.start - top + ext.shape[1]
        ok &= ext.view(torch.uint8).equal(whole[:, a:b].contiguous().view(
            torch.uint8))
        ok &= top == (2 if s > 0 else 0) and b == min(rows.stop + 2,
                                                      rows.total)
    return bool(ok)


def main():
    group, rank, world, store, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from streamflow_tpu_torch import parallel
    from streamflow_tpu_torch.parallel.multihost import shutdown

    assert parallel.initialize(f"file://{store}", world, rank,
                               device="cpu") == (rank, world)
    rec = {}
    for case, (dw, h, w, b, iters, n_data, n_seq) in GROUPS[group].items():
        model = port_model(dw, out)
        mesh = parallel.make_mesh(n_data, n_seq)
        rec["mesh"] = [mesh.d, mesh.s]
        imgs = torch.from_numpy(clip(h, w, b))
        for it in iters:
            flows = parallel.make_seq_sharded_forward(model, mesh, it)(imgs)
            np.save(os.path.join(out, f"{case}_{it}_{rank}.npy"),
                    flows.numpy())
        if group == "grid":
            try:
                parallel.make_seq_sharded_forward(model, mesh, 1)(imgs[:1])
                rec["odd_batch_refused"] = False
            except ValueError:
                rec["odd_batch_refused"] = True
    if group == "two":
        rec["exchanges_exact"] = exchanges_exact(mesh)
        try:
            parallel.make_mesh(n_data=2, n_seq=2)
            rec["bad_world_refused"] = False
        except ValueError:
            rec["bad_world_refused"] = True
        # a seq group of one: each rank's data rows whole
        model = port_model("auto", out)
        imgs = torch.from_numpy(clip(112, 128, 2))
        fwd = parallel.make_seq_sharded_forward(
            model, parallel.make_mesh(n_data=2), 2)
        got = fwd(imgs)
        want = model(imgs[rank:rank + 1], iters=2, test_mode=True)
        rec["solo_bit_for_bit"] = bool(torch.equal(got, want))
    with open(os.path.join(out, f"{group}_{rank}.json"), "w") as fh:
        json.dump(rec, fh)
    shutdown()


if __name__ == "__main__":
    main()
