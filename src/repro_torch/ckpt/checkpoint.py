"""Atomic, asynchronous checkpoints of the training state.

Port of ``src/repro/ckpt/checkpoint.py``: ``save`` takes CPU copies of the
state tree now and writes them with ``torch.save`` on a background thread
into ``step_N/``, as a ``.tmp`` file renamed to its name once it is flushed,
so a crashed save is never mistaken for a checkpoint. ``restore`` copies a
checkpoint into the tensors of a target state of the same tree, in place:
each leaf keeps its device, dtype and pinnedness, so optimizer states that
live in pinned host memory are restored there.

Each rank of ``world`` (one, unless the step runs on several data ranks:
the manual sync or the xla path's sharded layouts) saves and restores its
own file, ``state_rank{r}_of{world}.pt``: its shards of the sharded
leaves, with their optimizer states (a host chunk's pinned shards, restored
into pinned memory; a ``zero1_persistent`` leaf's state shards beside its
replicated weights) and shard-sized residuals, and its row of each
replicated leaf's residual under the manual sync. A
step counts only once every rank's file is in it, so a crash between two
ranks' saves leaves every rank resuming from the same earlier step. Each
rank writes on a thread of its own, so one rank may list the directory
while another still writes: ``restore_latest`` takes the newest step
complete on every rank's listing (a MIN all-reduce), so the ranks resume
from one step. A checkpoint saved at another world size is refused, not
resharded.

The fused-Adam kernel writes pinned host states asynchronously, so a save
reads them only when the CUDA stream is idle, and raises otherwise; the
training loop's per-step loss read-back leaves it idle.
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
import threading
from typing import Any

import torch
import torch.distributed as dist

STATE_FILE = re.compile(r"state_rank(\d+)_of(\d+)\.pt")  # rank, world


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
    rank: int = 0
    world: int = 1

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    @property
    def state_file(self) -> str:
        """This rank's file in a step's directory."""
        return f"state_rank{self.rank}_of{self.world}.pt"

    # --- save ----------------------------------------------------------------
    def save(self, step: int, state: Any, extra: dict | None = None, *, sync: bool = False):
        """Snapshot to host memory now; write to disk in the background."""
        assert_stream_idle(state)
        payload = {"step": step, "state": _to_cpu(state), "extra": dict(extra or {}),
                   "rank": self.rank, "world": self.world}
        if self._thread is not None:
            self._thread.join()  # one in-flight save at a time

        def write():
            final_dir = os.path.join(self.directory, f"step_{step}")
            os.makedirs(final_dir, exist_ok=True)
            final = os.path.join(final_dir, self.state_file)
            tmp = final + ".tmp"
            with open(tmp, "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)  # atomic publish
            if self.rank == 0:
                self._gc()

        self._thread = threading.Thread(target=write, daemon=False)
        self._thread.start()
        if sync:
            self._thread.join()

    def wait(self):
        if self._thread is not None:
            self._thread.join()

    def _gc(self):
        """Remove every step older than the ``keep`` newest complete ones,
        incomplete ones too: each rank publishes its steps in order, so
        below a complete step a step lacking a rank's file was left by a
        crash and will not be completed."""
        done = self.steps()
        if len(done) <= self.keep:
            return
        for s in self._step_dirs():
            if s < done[-self.keep]:
                shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)

    def _step_dirs(self) -> list[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.directory)
                      if name.startswith("step_") and not name.endswith(".tmp"))

    # --- restore ---------------------------------------------------------------
    def steps(self) -> list[int]:
        """Complete steps: those that hold the file of every rank of
        ``world``. Raises if a step was saved at another world size."""
        want = {f"state_rank{r}_of{self.world}.pt" for r in range(self.world)}
        out = []
        for s in self._step_dirs():
            files = set(os.listdir(os.path.join(self.directory, f"step_{s}")))
            worlds = {int(m.group(2)) for m in map(STATE_FILE.fullmatch, files) if m}
            if worlds - {self.world}:
                raise ValueError(f"step_{s} was saved at world size {sorted(worlds)}; this run "
                                 f"has {self.world} rank(s): a checkpoint is not resharded")
            if want <= files:
                out.append(s)
        return out

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any) -> tuple[Any, dict]:
        """Load checkpoint ``step`` into ``target`` (a state of the same tree,
        e.g. a fresh ``StepArtifacts.init``), in place. Returns (state, extra)."""
        path = os.path.join(self.directory, f"step_{step}", self.state_file)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        saved = (payload.get("rank", 0), payload.get("world", 1))
        if saved != (self.rank, self.world):
            raise ValueError(f"{path} holds rank {saved[0]} of {saved[1]}, want rank "
                             f"{self.rank} of {self.world}")
        return _copy_into(target, payload["state"]), payload["extra"]

    def agreed_latest_step(self) -> int | None:
        """The newest step complete for every rank: on several ranks (an
        initialised process group) the minimum of each rank's
        ``latest_step``, one all-reduce, so that a rank listing the
        directory while another still writes its file agrees with that
        rank. A rank's files are published in step order, so the minimum is
        complete for every rank."""
        step = self.latest_step()
        if self.world == 1 or not dist.is_initialized():
            return step
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
        t = torch.tensor([-1 if step is None else step], dtype=torch.int64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return None if int(t) < 0 else int(t)

    def restore_latest(self, target: Any):
        """Restore the newest step every rank holds (``agreed_latest_step``)
        into ``target``: (step, state, extra), or None without one."""
        step = self.agreed_latest_step()
        if step is None:
            return None
        state, extra = self.restore(step, target)
        return step, state, extra
