"""What the 12-iteration accuracy guard can judge (port of
tools/probe_guard.py): whether a difference between the kernel path and
the plain path at many iterations is a kernel fault or the refinement
loop amplifying rounding.

  A. input sensitivity alone: the f32 plain path on ``imgs`` against
     ``imgs + 1e-4``, same weights, no kernels involved;
  B. the f32 kernels on the device against the f32 plain path on the CPU,
     by iteration count (1, 2, 4, 8, 12): rounding amplified by the loop
     grows with the count; a kernel fault is large at 1 already.

Both run on random weights (``tools/common.py::init_weights``, fan-in
scaled, seed 0) and, with ``--ckpt``, on trained weights (e.g.
``probe_bf16``'s ``best.npz``): the loop amplifies on random weights and
should damp on trained ones. Each stat is the EPE between the two flows
(max and mean, px) beside both flows' largest |value| and the global
relative EPE (max EPE / max(1, max |ref|), the guard's measure). TF32
is off (``tools/common.py::strict_f32``), as in ``probe_bf16``.

The flows at k iterations are the k-th of one forward's per-iteration
flows (the model's train-mode output, run without gradients): the loop is
causal, so they are a k-iteration test-mode forward's flows (bit for bit
on the CPU: tests/test_torch_probes.py), and each path runs once.

    python -m streamflow_tpu_torch.tools.probe_guard [--height 436]
        [--width 1024] [--ckpt best.npz] [--device cuda|cpu]
        [--results chiprun_out/probe_guard.txt]

Prints one line per control and count and one JSON line, and appends
them to ``--results``. ``--device cpu`` runs the "kernel" path on the CPU
too (control B reads 0).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Sequence

import torch

from streamflow_tpu_torch.tools.common import (RESULTS_DIR, append_results,
                                               device_record, strict_f32)
from streamflow_tpu_torch.tools.probe_bf16 import eval_clip

ITERS_A = (2, 12)
ITERS_B = (1, 2, 4, 8, 12)
EPS = 1e-4          # control A's input perturbation, in pixel values
T = 4


def iter_flows(model, clip: torch.Tensor, iters: int) -> torch.Tensor:
    """(iters, B, T-1, H, W, 2) f32 flows on the CPU: after each
    iteration."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        return model(clip.to(dev), iters=iters).float().cpu()


def stats(a: torch.Tensor, b: torch.Tensor) -> Dict[str, float]:
    """EPE of ``a`` against ``b`` (the reference): max and mean px, both
    flows' largest |value|, and the global relative EPE."""
    epe = (a.double() - b.double()).norm(dim=-1)
    mag = float(b.double().norm(dim=-1).max())
    return {"max_epe": float(epe.max()), "mean_epe": float(epe.mean()),
            "a_max": float(a.abs().max()), "b_max": float(b.abs().max()),
            "rel_epe": float(epe.max()) / max(1.0, mag)}


def control_a(plain, clip: torch.Tensor, iters: Sequence[int],
              ref: torch.Tensor) -> Dict[int, dict]:
    """The plain model at ``clip + EPS`` against ``clip`` (``ref``: the
    plain model's per-iteration flows of ``clip``)."""
    pert = iter_flows(plain, clip + EPS, max(iters))
    return {k: stats(pert[k - 1], ref[k - 1]) for k in iters}


def control_b(kernels, clip: torch.Tensor, iters: Sequence[int],
              ref: torch.Tensor) -> Dict[int, dict]:
    """The kernel model against the plain model's per-iteration flows
    ``ref``, after each count."""
    got = iter_flows(kernels, clip, max(iters))
    return {k: stats(got[k - 1], ref[k - 1]) for k in iters}


def models(variables, device, iters: int):
    """(plain f32 model on the CPU, f32 kernel model on ``device``) holding
    ``variables``, or random weights from seed 0 when it is None."""
    import copy

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.params import load_jax
    from streamflow_tpu_torch.tools.common import init_weights

    plain = create_model("streamflow", cfg=StreamFlowConfig(
        T=T, iters=iters, mixed_precision=False), device="cpu")
    if variables is None:
        init_weights(plain, 0)
    else:
        load_jax(plain, variables)
    return plain, copy.deepcopy(plain).to(device)


def run(variables, clip, device) -> dict:
    """Controls A and B on one set of weights."""
    from streamflow_tpu_torch.utils.profiling import phase_timer

    n = max(ITERS_A + ITERS_B)
    plain, kernels = models(variables, device, n)
    with phase_timer("probe_guard plain (cpu)"):
        ref = iter_flows(plain, clip, n)
    with phase_timer("probe_guard control A"):
        a = control_a(plain, clip, ITERS_A, ref)
    with phase_timer("probe_guard control B", sync=device):
        b = control_b(kernels, clip, ITERS_B, ref)
    return {"A": a, "B": b}


def lines_of(name: str, res: dict) -> list:
    def fmt(s):
        return (f"max_epe={s['max_epe']:.6g} mean_epe={s['mean_epe']:.6g} "
                f"rel={s['rel_epe']:.3g} |a|max={s['a_max']:.4g} "
                f"|b|max={s['b_max']:.4g}")
    out = [f"{name} weights:",
           f"  A. input-perturbation control (f32 plain, +{EPS} input):"]
    out += [f"    iters={k}: {fmt(s)}" for k, s in res["A"].items()]
    out.append("  B. f32 kernels vs f32 plain, by iteration count:")
    out += [f"    iters={k}: {fmt(s)}" for k, s in res["B"].items()]
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--height", type=int, default=436)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--ckpt", default=None,
                   help="trained weights (.npz, flax layout), run beside "
                        "the random ones")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--results",
                   default=str(RESULTS_DIR / "probe_guard.txt"))
    args = p.parse_args(argv)
    strict_f32()

    from streamflow_tpu_torch.training.checkpoint import load_variables_npz
    from streamflow_tpu_torch.utils.profiling import phase_report, phase_reset

    phase_reset()
    clip = eval_clip(T, args.height, args.width)
    weights = {"random": None}
    if args.ckpt:
        weights["trained"] = load_variables_npz(args.ckpt)
    results, lines = {}, [f"probe_guard: {args.height}x{args.width} T={T}, "
                          f"f32, device {args.device}"]
    for name, variables in weights.items():
        results[name] = run(variables, clip, args.device)
        lines += lines_of(name, results[name])
    record = {"tool": "probe_guard", "size": [args.height, args.width],
              "padded": list(clip.shape[2:4]), "eps": EPS,
              **device_record(args.device), "ckpt": args.ckpt,
              **{name: {c: {str(k): s for k, s in r[c].items()}
                        for c in r} for name, r in results.items()},
              "phases_s": {k: v["total_s"]
                           for k, v in phase_report().items()}}
    lines.append(json.dumps(record))
    print("\n".join(lines), flush=True)
    append_results(args.results, lines)
    return record


if __name__ == "__main__":
    main()
