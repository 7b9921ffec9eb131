"""bf16 end-to-end divergence on trained dynamics (port of
tools/probe_bf16.py).

On random weights the refinement loop amplifies any difference in the
order of its sums (about 2.7x an iteration at the fan-in scale), so a
12-iteration comparison of two kernel sets on random weights judges
nothing. Released weights are not in the repository. This probe trains
the canonical StreamFlow itself on synthetic clips for a few hundred
steps, enough for the update block to learn damped updates, then runs one
fixed clip through three paths at the full 12 iterations, test mode:

- the f32 plain path on the CPU (every kernel's plain PyTorch version:
  the reference),
- the f32 kernels on the card,
- the bf16 kernels on the card (the released configuration),

and reports each kernel path's EPE against the reference (mean, p99,
max, in px) beside the reference's |flow| mean and max. TF32 is off
(``tools/common.py::strict_f32``): PyTorch's default lets cuDNN's f32
convs run in TF32, which would put the f32 kernel path ~1e-3 off.

Training as JAX's probe (tools/probe_bf16.py:66-96): the canonical config
(TwinsCSC, SKUpdateBlockTAMv3 + GMA, T=4, 12 iterations, bf16 compute with
f32 parameters, remat, ``dw_impl='auto'``), its own initialisation from a
seed, AdamW + OneCycle at lr 2.5e-4 over ``steps + 100`` steps
(``make_optimizer``'s schedule then spans ``steps + 200``, as JAX's
``make_optimizer(num_steps=steps + 100)`` does), gamma 0.85, one clip a
step from ``synth_batch(step + 1)``: JAX's NumPy formula and seeds
(piecewise-constant images with noise, smooth flows). The evaluation clip
is ``np.random.default_rng(0)``'s first draw, padded in 'sintel' mode.

    python -m streamflow_tpu_torch.tools.probe_bf16 [--steps 400]
        [--height 288] [--width 512] [--eval_height 436] [--eval_width 1024]
        [--T 4] [--iters 12] [--device cuda|cpu] [--out build/probe_bf16]
        [--results chiprun_out/probe_bf16.txt]

Prints the training lines, the comparison's lines and one JSON line, and
appends the lines and the JSON to ``--results``. Saves the trained
weights as ``--out``/best.npz in the JAX package's flax layout
(``save_params_npz`` of ``params.to_jax_variables``), which ``--ckpt`` of
every serving tool and of ``probe_guard`` loads. With ``--device cpu``
every path runs on the CPU: the "kernel" paths are then the plain path
itself (EPE 0); nothing moves to the CPU unasked.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict

import numpy as np
import torch

from streamflow_tpu_torch.tools.common import (RESULTS_DIR, append_results,
                                               device_record, strict_f32)

LR, GAMMA, SEED = 2.5e-4, 0.85, 0
# the two kernel paths, each against the f32 plain path on the CPU
PATHS = (("f32_kernels", "f32 kernels vs f32 plain", False),
         ("bf16_kernels", "bf16 kernels vs f32 plain", True))


def synth_batch(seed: int, t: int, h: int, w: int) -> Dict[str, np.ndarray]:
    """JAX's synthetic batch (tools/probe_bf16.py:66-82), bit for bit:
    one clip of piecewise-constant 8x8 blocks plus N(0, 8^2) noise,
    clipped to [0, 255], and flows of 32x32 blocks of N(0, 2^2) px, all
    valid. h and w must be multiples of 32."""
    if h % 32 or w % 32:
        raise ValueError(f"synth_batch needs h and w divisible by 32, got "
                         f"{h}x{w}")
    g = np.random.default_rng(seed)
    base = g.integers(0, 255, (1, 1, h // 8, w // 8, 3)).astype(np.float32)
    imgs = np.repeat(np.repeat(base, 8, axis=2), 8, axis=3)
    imgs = np.repeat(imgs, t, axis=1)
    imgs += g.normal(0, 8, imgs.shape)
    flow = np.repeat(np.repeat(
        g.normal(0, 2.0, (1, t - 1, h // 32, w // 32, 2)),
        32, axis=2), 32, axis=3).astype(np.float32)
    return {"images": np.clip(imgs, 0, 255).astype(np.float32),
            "flows": flow,
            "valids": np.ones((1, t - 1, h, w), np.float32)}


def train_config(t: int, iters: int):
    from streamflow_tpu_torch.config import StreamFlowConfig

    return StreamFlowConfig(T=t, iters=iters, mixed_precision=True,
                            remat=True)


def init_model(t: int, iters: int, device, seed: int = SEED):
    """The probe's training model: the canonical StreamFlow
    (``train_config``) with its own initialisation from ``seed``, as JAX's
    probe starts from ``model.init`` with a seeded key."""
    from streamflow_tpu_torch.models import create_model

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return create_model("streamflow", cfg=train_config(t, iters),
                            device=device, train=True)


def train(model, steps: int, t: int, h: int, w: int, iters: int,
          log: Callable[[str], None] = print, print_every: int = 50):
    """Train ``model`` (a training model) for ``steps`` steps on
    ``synth_batch(1..steps)`` with the probe's optimizer and loss; returns
    the TrainState and the last step's metrics (floats). The loop's time
    is the ``probe train`` phase of ``utils.profiling``."""
    from streamflow_tpu_torch.training.state import TrainState
    from streamflow_tpu_torch.training.step import make_train_step
    from streamflow_tpu_torch.utils.profiling import phase_timer

    device = next(model.parameters()).device
    state = TrainState.create(model, lr=LR, num_steps=steps + 100)
    step = make_train_step(gamma=GAMMA, iters=iters)
    t0 = time.time()
    metrics = {}
    with phase_timer("probe train", sync=device):
        for i in range(steps):
            batch = {k: torch.from_numpy(v).to(device) for k, v in
                     synth_batch(i + 1, t, h, w).items()}
            metrics = step(state, batch)
            if i % print_every == 0 or i == steps - 1:
                log(f"step {i:4d}: loss={float(metrics['loss']):9.3f} "
                    f"epe={float(metrics['epe']):7.3f} "
                    f"({time.time() - t0:.0f}s)")
    return state, {k: float(v) for k, v in metrics.items()}


def trained_variables(state) -> dict:
    """The trained weights in the JAX package's flax layout."""
    from streamflow_tpu_torch.params import to_jax_variables

    return to_jax_variables(state.model.state_dict(), state.model.cfg)


def eval_clip(t: int, eh: int, ew: int, seed: int = SEED) -> torch.Tensor:
    """JAX's evaluation clip: ``default_rng(seed)``'s first draw of a
    (1, t, eh, ew, 3) uint8-range clip, padded in 'sintel' mode; on the
    CPU."""
    from streamflow_tpu_torch.ops.padding import InputPadder

    clip = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 255, (1, t, eh, ew, 3)).astype(np.float32))
    return InputPadder((eh, ew, 3), mode="sintel").pad(clip)


def eval_model(variables, t: int, iters: int, mixed_precision: bool,
               device):
    """An inference StreamFlow on ``device`` holding ``variables`` (flax
    layout)."""
    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.params import load_jax

    model = create_model("streamflow", cfg=StreamFlowConfig(
        T=t, iters=iters, mixed_precision=mixed_precision), device=device)
    load_jax(model, variables)
    return model


def flows_of(model, clip: torch.Tensor) -> torch.Tensor:
    """The model's test-mode flows of ``clip`` as f32 on the CPU."""
    dev = next(model.parameters()).device
    return model(clip.to(dev), test_mode=True).float().cpu()


def epe_stats(flows: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """EPE of ``flows`` against ``ref`` in px: mean, p99, max."""
    epe = (flows.double() - ref.double()).norm(dim=-1).flatten().numpy()
    return {"epe_mean": float(epe.mean()),
            "epe_p99": float(np.percentile(epe, 99)),
            "epe_max": float(epe.max())}


def compare(variables, clip: torch.Tensor, t: int, iters: int,
            device) -> dict:
    """The kernel paths' EPE against the f32 plain path on the CPU, with
    the reference's |flow| mean and max and each path's flows."""
    from streamflow_tpu_torch.utils.profiling import phase_timer

    with phase_timer("probe f32 plain (cpu)"):
        ref = flows_of(eval_model(variables, t, iters, False, "cpu"), clip)
    mag = ref.double().norm(dim=-1)
    out = {"flow_ref_mean": float(mag.mean()), "flow_ref_max":
           float(mag.max()), "flows": {"f32_plain": ref}}
    for key, _, mp in PATHS:
        with phase_timer(f"probe {key}", sync=device):
            f = flows_of(eval_model(variables, t, iters, mp, device), clip)
        out["flows"][key] = f
        out[key] = epe_stats(f, ref)
    return out


def report_lines(res: dict, head: str) -> list:
    lines = [f"{head}; |flow| mean {res['flow_ref_mean']:.2f} max "
             f"{res['flow_ref_max']:.2f} px"]
    for key, name, _ in PATHS:
        s = res[key]
        lines.append(f"  {name}: EPE mean {s['epe_mean']:.4f} px, p99 "
                     f"{s['epe_p99']:.4f}, max {s['epe_max']:.4f}")
    return lines


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--height", type=int, default=288)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--eval_height", type=int, default=436)
    p.add_argument("--eval_width", type=int, default=1024)
    p.add_argument("--T", type=int, default=4)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--out", default=str(RESULTS_DIR.parent / "build" /
                                        "probe_bf16"),
                   help="directory of best.npz (the trained weights)")
    p.add_argument("--results",
                   default=str(RESULTS_DIR / "probe_bf16.txt"))
    args = p.parse_args(argv)
    strict_f32()

    from streamflow_tpu_torch.training.checkpoint import save_params_npz
    from streamflow_tpu_torch.utils.profiling import (phase_report,
                                                      phase_reset,
                                                      phase_timer)

    phase_reset()
    if torch.device(args.device).type == "cuda":
        from streamflow_tpu_torch import _build

        with phase_timer("probe build"):  # not inside the first step
            _build.library()
    t, h, w = args.T, args.height, args.width
    state, last = train(init_model(t, args.iters, args.device), args.steps,
                        t, h, w, args.iters)
    variables = trained_variables(state)
    os.makedirs(args.out, exist_ok=True)
    ckpt = os.path.join(args.out, "best.npz")
    save_params_npz(ckpt, variables)
    del state

    eh, ew = args.eval_height, args.eval_width
    clip = eval_clip(t, eh, ew)
    res = compare(variables, clip, t, args.iters, args.device)
    lines = report_lines(res, f"probe_bf16: {args.steps} steps at {h}x{w}, "
                         f"eval {eh}x{ew} T={t} iters={args.iters}")
    phases = phase_report()
    record = {"tool": "probe_bf16", "steps": args.steps, "train": [h, w],
              "eval": [eh, ew], "padded": list(clip.shape[2:4]), "T": t,
              "iters": args.iters, **device_record(args.device),
              "last_loss": last["loss"], "last_epe": last["epe"],
              "ms_per_step": 1e3 * phases["probe train"]["total_s"]
              / max(args.steps, 1),
              "flow_ref_mean": res["flow_ref_mean"],
              "flow_ref_max": res["flow_ref_max"],
              **{key: res[key] for key, _, _ in PATHS},
              "phases_s": {k: v["total_s"] for k, v in phases.items()},
              "ckpt": ckpt}
    lines.append(json.dumps(record))
    print("\n".join(lines), flush=True)
    append_results(args.results, lines)
    return record


if __name__ == "__main__":
    main()
