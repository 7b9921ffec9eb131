"""End-of-run training curves (port of streamflow_tpu/utils/plots.py;
reference train_mf.py:309-337): the train-EPE curve and one plot per
validation metric with its best and latest values marked, read from the
``metrics.jsonl`` that the port's ``MetricsLogger`` writes (its records
are the JAX logger's), into the same png files.

matplotlib is an optional plotting package: without it nothing is drawn
and the function returns ``[]``, as JAX's does. It runs on the host only.
"""

from __future__ import annotations

import json
from pathlib import Path


def plot_training_curves(output_dir: str) -> list:
    """Render curves from <output_dir>/metrics.jsonl -> png files.
    Returns the written paths. No-op (returns []) if matplotlib is absent."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return []

    out = Path(output_dir)
    path = out / "metrics.jsonl"
    if not path.exists():
        return []

    train_steps, train_epe = [], []
    val_records = []
    for line in path.read_text().splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "val" in rec:
            val_records.append((rec["step"], rec["val"]))
        elif "epe" in rec:
            train_steps.append(rec["step"])
            train_epe.append(rec["epe"])

    written = []
    if train_steps:
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.plot(train_steps, train_epe, lw=0.8)
        ax.set_xlabel("step")
        ax.set_ylabel("train EPE")
        ax.set_title("training EPE")
        fig.tight_layout()
        p = out / "train_epe.png"
        fig.savefig(p, dpi=120)
        plt.close(fig)
        written.append(str(p))

    if val_records:
        keys = sorted({k for _, v in val_records for k in v})
        for key in keys:
            pts = [(s, v[key]) for s, v in val_records if key in v]
            if not pts:
                continue
            xs, ys = zip(*pts)
            fig, ax = plt.subplots(figsize=(8, 4))
            ax.plot(xs, ys, marker="o")
            best_i = min(range(len(ys)), key=lambda i: ys[i])
            ax.annotate(f"best {ys[best_i]:.4f}", (xs[best_i], ys[best_i]),
                        textcoords="offset points", xytext=(5, 5))
            ax.annotate(f"latest {ys[-1]:.4f}", (xs[-1], ys[-1]),
                        textcoords="offset points", xytext=(5, -10))
            ax.set_xlabel("step")
            ax.set_ylabel(key)
            ax.set_title(f"validation {key}")
            fig.tight_layout()
            p = out / f"val_{key}.png"
            fig.savefig(p, dpi=120)
            plt.close(fig)
            written.append(str(p))
    return written
