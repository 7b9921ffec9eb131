"""Checkpoints of the port (counterpart of
streamflow_tpu/training/checkpoint.py; reference: torch.save dict
{model, optimizer, scheduler, total_steps} + latest.pth
delete-then-rewrite, train_mf.py:207-212, 264-283).

``CheckpointManager`` keeps the last N train states, one ``step_<n>.pt``
each, written atomically (a temporary file in the same directory,
flushed and fsynced, then ``os.replace``d: no crash window while the
latest is deleted, SURVEY §5.3), and resumes model, optimizer, schedule
and step exactly (train_mf.py:149-157).

Flat npz parameter files in the JAX package's layout (:55-92): one array
per flax path ("params/fnet/.../kernel"), so an npz written by either
package loads in the other. Into the port: ``params.load_jax(model,
load_variables_npz(path))``; out of it: ``save_params_npz(path,
{"params": tree})`` with the tree rebuilt from ``params.to_jax``.
"""

from __future__ import annotations

import os
import re
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

_STEP_FILE = re.compile(r"step_(\d+)\.pt")


def _host_copy(tree):
    """A copy of every tensor of a state_dict tree on the host, so that
    training can go on changing the live tensors while the copy is
    written."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


class CheckpointManager:
    """Keep-N train-state checkpoints in ``directory`` (counterpart of the
    JAX package's orbax manager, :23-52).

    ``save(state)`` skips a step that is not after the latest saved one;
    otherwise it copies the state to the host, then writes it on a thread
    of its own (``wait=True`` waits for the write). The file appears under
    its name only once it is complete, and only then is the oldest beyond
    ``max_to_keep`` deleted, so a failed or interrupted save leaves the
    earlier checkpoints as they were; a temporary file it leaves behind is
    not a step. A write's error is raised by the next call that waits
    for it (``save``, ``wait_until_finished``, ``restore``, ``close``)."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.dir = Path(directory).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def path(self, step: int) -> Path:
        return self.dir / f"step_{step}.pt"

    def all_steps(self) -> List[int]:
        """The saved steps, in increasing order."""
        steps = (_STEP_FILE.fullmatch(f) for f in os.listdir(self.dir))
        return sorted(int(m.group(1)) for m in steps if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state, wait: bool = False) -> bool:
        """Save ``state`` (a TrainState) at ``state.step``; returns whether
        it was saved."""
        self.wait_until_finished()
        step = int(state.step)
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        snapshot = _host_copy(state.state_dict())
        self._writer = threading.Thread(target=self._write,
                                        args=(step, snapshot), daemon=True)
        self._writer.start()
        if wait:
            self.wait_until_finished()
        return True

    def _write(self, step: int, snapshot) -> None:
        final = self.path(step)
        tmp = final.with_name(f"{final.name}.tmp{os.getpid()}")
        try:
            with open(tmp, "wb") as fh:
                torch.save(snapshot, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, final)
            fd = os.open(self.dir, os.O_RDONLY)   # make the rename durable
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            for old in self.all_steps()[:-self.max_to_keep]:
                self.path(old).unlink()
        except Exception as e:   # raised by the caller's next wait
            tmp.unlink(missing_ok=True)
            self._error = e

    def wait_until_finished(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("CheckpointManager: a save failed") from err

    def restore(self, state, step: Optional[int] = None):
        """Load checkpoint ``step`` (the latest by default) into ``state``
        (a TrainState built with this run's settings:
        ``TrainState.load_state_dict``) and return it. The file is read
        on the host; the parameters and AdamW's moments go to the
        parameters' device, AdamW's step counts stay on the host, where
        torch keeps them."""
        self.wait_until_finished()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        state.load_state_dict(torch.load(self.path(step), map_location="cpu",
                                         weights_only=True))
        return state

    def close(self) -> None:
        self.wait_until_finished()


def save_params_npz(path: str, params) -> None:
    """Flat-file param export (portable, dependency-free restore)."""
    flat = {}

    def rec(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                rec(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(tree)

    rec("", params)
    np.savez(path, **flat)


def load_params_npz(path: str):
    """Inverse of save_params_npz: rebuild the nested dict."""
    flat = np.load(path)
    params = {}
    for key in flat.files:
        parts = key.split("/")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return params


def load_variables_npz(path: str):
    """Load an npz as a flax variables dict: a bare params tree is wrapped
    as {'params': ...}; a full variables export with top-level 'params'
    (tools/convert.py's layout) is returned as it is."""
    tree = load_params_npz(path)
    return tree if "params" in tree else {"params": tree}
