"""The exchanges of one sequence-sharded forward (``parallel/seq.py``), a
rank: their count by kind and the bytes each rank sends and receives,
beside the bytes of the all_reduce form that carried halos and gathers
before (``parallel/exchange.py::traffic``).

    python -m streamflow_tpu_torch.tools.seq_traffic --n_seq 8 \\
        [--height 440] [--width 1024] [--run_width 128] [--iters 12] \\
        [--encoder basic|res18_3d|umt]

It starts ``n_seq`` processes on the CPU, one seq group over gloo (a
file store in a temporary directory), and runs the StreamFlow of the
config (the canonical one, or the encoder named; UMT with
decoder_dim=768) with seeded weights on a seeded clip, B=1, T=4, bf16,
sharded over them at height x run_width, under
``exchange.recording``. Each exchanged row of a halo or a gather spans
the clip's width (W/8 columns, W/32 of GSA's reduced tokens, W/16 of
UMT's), so its bytes are the width's multiple: every record is priced
by ``traffic`` at ``width``, its row bytes times width / run_width (a
sum, over channels, as it is). Prints a line a rank and kind, then one
JSON object. The forward runs on the CPU: nothing is timed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

T = 4
SEED = 0
TIMEOUT_S = 1800     # a process's time: its model build and one forward
MIB = 2 ** 20


def config_fields(encoder):
    """The config's fields beyond the canonical ones."""
    if encoder == "umt":
        return {"encoder": "umt", "decoder_dim": 768}
    return {"encoder": encoder} if encoder else {}


def priced(records, scale: int) -> dict:
    """``exchange.Exchange`` records of one rank, each priced by
    ``traffic`` with a halo's or a gather's row bytes times ``scale``:
    kind -> {n, sent, received, old} (bytes). Raises if a record's own
    bytes are not ``traffic``'s at the width it ran."""
    from streamflow_tpu_torch.parallel.exchange import traffic

    out = {}
    for e in records:
        if (e.sent, e.received) != tuple(e.planned()[:2]):
            raise AssertionError(f"seq_traffic: {e} is not its plan's")
        row = e.row_bytes * (1 if e.kind == "sum" else scale)
        t = traffic(e.kind, e.bounds, e.index, row, e.k)
        acc = out.setdefault(e.kind, dict(n=0, sent=0, received=0, old=0))
        acc["n"] += 1
        for key, v in zip(("sent", "received", "old"), t):
            acc[key] += v
    return out


def worker(rank: int, args, store: str, out: str) -> None:
    import torch

    from streamflow_tpu_torch import parallel
    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.parallel import exchange
    from streamflow_tpu_torch.parallel.multihost import shutdown
    from streamflow_tpu_torch.tools.common import init_weights

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.n_seq))
    parallel.initialize(f"file://{store}", args.n_seq, rank, device="cpu")
    try:
        model = create_model("streamflow", cfg=StreamFlowConfig(
            T=T, iters=args.iters, mixed_precision=True,
            **config_fields(args.encoder)), device="cpu")
        init_weights(model, SEED)
        clip = torch.randint(0, 255, (1, T, args.height, args.run_width, 3),
                             generator=torch.Generator().manual_seed(
                                 SEED)).float()
        fwd = parallel.make_seq_sharded_forward(
            model, parallel.make_mesh(n_seq=args.n_seq), args.iters)
        with exchange.recording() as rec:
            flows = fwd(clip)
        assert flows.shape == (1, T - 1, args.height, args.run_width, 2)
    finally:
        shutdown()
    with open(os.path.join(out, f"{rank}.json"), "w") as fh:
        json.dump(priced(rec, args.width // args.run_width), fh)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n_seq", type=int, default=2)
    p.add_argument("--height", type=int, default=440)
    p.add_argument("--width", type=int, default=1024,
                   help="the clip's width that the bytes are priced at")
    p.add_argument("--run_width", type=int, default=128,
                   help="the width the forward runs at (divides --width)")
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--encoder", default=None,
                   choices=["basic", "res18_3d", "umt"])
    p.add_argument("--worker", type=int, default=None,
                   help=argparse.SUPPRESS)   # a process's rank
    p.add_argument("--tmp", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.width % args.run_width:
        raise SystemExit(f"seq_traffic: --run_width {args.run_width} does "
                         f"not divide --width {args.width}")
    if args.worker is not None:
        worker(args.worker, args, os.path.join(args.tmp, "store"), args.tmp)
        return 0
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "streamflow_tpu_torch.tools.seq_traffic",
             *(argv if argv is not None else sys.argv[1:]),
             "--worker", str(r), "--tmp", tmp], env=env)
            for r in range(args.n_seq)]
        codes = []
        try:
            for q in procs:
                codes.append(q.wait(timeout=TIMEOUT_S))
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
        if any(codes):
            raise SystemExit(f"seq_traffic: exit codes {codes}")
        ranks = []
        for r in range(args.n_seq):
            with open(os.path.join(tmp, f"{r}.json")) as fh:
                ranks.append(json.load(fh))
    what = (f"{args.encoder or 'canonical'} bf16 1x{T}x{args.height}x"
            f"{args.width} iters {args.iters}, n_seq {args.n_seq}")
    for r, kinds in enumerate(ranks):
        for kind, v in sorted(kinds.items()):
            print(f"seq_traffic {what}: rank {r} {kind} x{v['n']}: sent "
                  f"{v['sent'] / MIB:.3f} MiB, received "
                  f"{v['received'] / MIB:.3f} MiB; the all_reduce form "
                  f"{v['old'] / MIB:.3f} MiB each way")
    print(json.dumps({"config": what, "ranks": [
        {kind: {k: (x if k == "n" else round(x / MIB, 4))
                for k, x in v.items()} for kind, v in kinds.items()}
        for kinds in ranks]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
