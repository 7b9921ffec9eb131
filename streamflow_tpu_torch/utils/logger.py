"""Training logger (port of streamflow_tpu/utils/logger.py; reference
Logger, train_mf.py:88-142): running means per metric, periodic
`[step/num_steps, lr] metrics | s/it ETA` lines, stdout teed to a log
file, and JSONL metric records in ``metrics.jsonl``, the same lines and
records as the JAX package's.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional


class Tee:
    """Mirror stdout to a file (reference train_mf.py:136-142)."""

    def __init__(self, path):
        self._file = open(path, "a", buffering=1)
        self._stdout = sys.stdout

    def write(self, data):
        self._stdout.write(data)
        self._file.write(data)

    def flush(self):
        self._stdout.flush()
        self._file.flush()

    def install(self):
        sys.stdout = self
        return self

    def close(self):
        """Give stdout back and close the file."""
        if sys.stdout is self:
            sys.stdout = self._stdout
        self._file.close()


class MetricsLogger:
    def __init__(self, output_dir: str, num_steps: int, print_freq: int = 100):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.num_steps = num_steps
        self.print_freq = print_freq
        self.running: Dict[str, float] = {}
        self.count = 0
        self.step = 0
        self._t_start = time.time()
        self._jsonl = open(self.dir / "metrics.jsonl", "a", buffering=1)
        self.val_results: Dict[int, Dict[str, float]] = {}

    def push(self, metrics: Dict[str, float], lr: Optional[float] = None):
        self.step += 1
        self.count += 1
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        if self.step % self.print_freq == 0:
            means = {k: v / self.count for k, v in self.running.items()}
            elapsed = time.time() - self._t_start
            rate = elapsed / max(self.step, 1)
            eta_h = rate * (self.num_steps - self.step) / 3600
            lr_s = f", lr {lr:.2e}" if lr is not None else ""
            body = ", ".join(f"{k} {v:.4f}" for k, v in sorted(means.items()))
            print(f"[{self.step}/{self.num_steps}{lr_s}] {body} "
                  f"| {rate:.2f}s/it ETA {eta_h:.2f}h", flush=True)
            self._jsonl.write(json.dumps(
                {"step": self.step, "lr": lr, **means}) + "\n")
            self.running, self.count = {}, 0

    def push_val(self, step: int, results: Dict[str, float]):
        self.val_results[step] = results
        self._jsonl.write(json.dumps({"step": step, "val": results}) + "\n")

    def best_step(self, key: str) -> Optional[int]:
        if not self.val_results:
            return None
        steps = [s for s, r in self.val_results.items() if key in r]
        return min(steps, key=lambda s: self.val_results[s][key]) if steps else None

    def close(self):
        self._jsonl.close()
