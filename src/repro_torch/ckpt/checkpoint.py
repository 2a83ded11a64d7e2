"""Atomic, asynchronous checkpoints of the training state.

Port of ``src/repro/ckpt/checkpoint.py`` for one process: ``save`` takes
CPU copies of the state tree now and writes them with ``torch.save`` on a
background thread into ``step_N.tmp/``, renamed to ``step_N/`` once the
file is flushed, so a crashed save is never mistaken for a checkpoint.
``restore`` copies a checkpoint into the tensors of a target state of the
same tree, in place: each leaf keeps its device, dtype and pinnedness, so
optimizer states that live in pinned host memory are restored there.

The fused-Adam kernel writes pinned host states asynchronously, so a save
reads them only when the CUDA stream is idle, and raises otherwise; the
training loop's per-step loss read-back leaves it idle.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import threading
from typing import Any

import torch

STATE_FILE = "state.pt"


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def assert_stream_idle(state) -> None:
    """Raise unless the CPU may read every pinned host tensor of ``state``:
    all work queued on the current CUDA stream has finished."""
    if any(isinstance(t, torch.Tensor) and t.device.type == "cpu" and t.is_pinned()
           for t in _leaves(state)):
        if not torch.cuda.current_stream().query():
            raise RuntimeError("checkpoint read of pinned host states while the CUDA "
                               "stream still runs work that writes them")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


@torch.no_grad()
def _copy_into(target, saved, path="state"):
    """``saved`` (CPU) into ``target`` in place; returns the merged tree
    (non-tensor leaves, such as step counters, are taken from ``saved``)."""
    if isinstance(target, dict):
        if set(target) != set(saved):
            raise ValueError(f"{path}: keys {sorted(saved)} != {sorted(target)}")
        return {k: _copy_into(target[k], saved[k], f"{path}/{k}") for k in target}
    if isinstance(target, list):
        if len(target) != len(saved):
            raise ValueError(f"{path}: {len(saved)} entries, want {len(target)}")
        return [_copy_into(t, s, f"{path}/{i}") for i, (t, s) in enumerate(zip(target, saved))]
    if isinstance(target, torch.Tensor):
        if saved.shape != target.shape or saved.dtype != target.dtype:
            raise ValueError(f"{path}: {tuple(saved.shape)} {saved.dtype}, want "
                             f"{tuple(target.shape)} {target.dtype}")
        target.copy_(saved)
        return target
    return saved


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # --- save ----------------------------------------------------------------
    def save(self, step: int, state: Any, extra: dict | None = None, *, sync: bool = False):
        """Snapshot to host memory now; write to disk in the background."""
        assert_stream_idle(state)
        payload = {"step": step, "state": _to_cpu(state), "extra": dict(extra or {})}
        if self._thread is not None:
            self._thread.join()  # one in-flight save at a time

        def write():
            tmp = os.path.join(self.directory, f"step_{step}.tmp")
            final = os.path.join(self.directory, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)  # atomic publish
            self._gc()

        self._thread = threading.Thread(target=write, daemon=False)
        self._thread.start()
        if sync:
            self._thread.join()

    def wait(self):
        if self._thread is not None:
            self._thread.join()

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)

    # --- restore ---------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name, STATE_FILE)):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any) -> tuple[Any, dict]:
        """Load checkpoint ``step`` into ``target`` (a state of the same tree,
        e.g. a fresh ``StepArtifacts.init``), in place. Returns (state, extra)."""
        path = os.path.join(self.directory, f"step_{step}", STATE_FILE)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        return _copy_into(target, payload["state"]), payload["extra"]

    def restore_latest(self, target: Any):
        step = self.latest_step()
        if step is None:
            return None
        state, extra = self.restore(step, target)
        return step, state, extra
