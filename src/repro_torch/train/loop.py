"""Fault-tolerant training loop.

Port of ``src/repro/train/loop.py`` (``:41-225``): resume from the latest
checkpoint (params, optimizer states and the data step), periodic
asynchronous checkpoints with atomic publish, a final synchronous save on
SIGTERM, a straggler count (steps slower than ``deadline_factor`` times the
trailing median) and a NaN-loss skip. There is no jit and no donation: the
step updates the state in place, and the loop synchronises once per step,
at the loss read-back; it reports the loss (cross-entropy plus the MoE aux
loss) and the cross-entropy apart. With ``telemetry=`` it records the ``train.*``
metrics (step-time histogram, loss gauge, step / NaN-skip / straggler
counters, the device-memory high-water mark on CUDA) and a ``train.step``
span per step; with ``drift=`` each step's wall time and watermark go to
the online measured-vs-modeled ``obs.DriftMonitor``. ``log`` is a callable
or an ``obs.StructuredLogger`` (``obs.as_logger``, ``loop.py:59-70``): the
human lines are unchanged, and each is also a record (``resume``,
``step``, ``nan_skip``, ``straggler``, ``preempt``) with its fields; a
``sync_config`` record (no line) names the gradient sync, its strategy and
the world.
"""
from __future__ import annotations

import dataclasses
import math
import signal
import statistics
import time
from typing import Callable

import torch

from repro_torch import obs
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.optim.adam import tree_leaves


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    deadline_factor: float = 3.0  # straggler threshold vs median step time
    max_nan_skips: int = 3


@dataclasses.dataclass
class LoopResult:
    steps_run: int
    final_step: int
    losses: list[float]  # metrics["loss"]: cross-entropy plus the MoE aux loss
    ces: list[float]  # metrics["ce"], the cross-entropy alone, of the same steps
    resumed_from: int | None
    straggler_events: int
    nan_skips: int
    step_times: list[float]  # host wall seconds of each finite step
    state: dict  # the final training state


def train_loop(step_artifacts, pipeline: SyntheticTokenPipeline,
               ckpt: CheckpointManager | None, loop_cfg: LoopConfig, *,
               generator: torch.Generator | None = None,
               log: Callable[[str], None] | obs.StructuredLogger = print,
               telemetry: obs.Telemetry | None = None,
               drift: obs.DriftMonitor | None = None) -> LoopResult:
    """Run ``loop_cfg.total_steps`` steps of ``step_artifacts.fn``, from the
    latest checkpoint of ``ckpt`` if it has one, else from
    ``step_artifacts.init(generator)``."""
    logger = obs.as_logger(log, name="loop")
    tel = telemetry if telemetry is not None else obs.NULL_TELEMETRY
    reg, tracer = tel.registry, tel.tracer
    step_time_h = reg.histogram("train.step_time_s")
    loss_g = reg.gauge("train.loss")
    mem_g = reg.gauge("train.device_mem_watermark_bytes")
    steps_c = reg.counter("train.steps")
    nan_c = reg.counter("train.nan_skips")
    straggler_c = reg.counter("train.straggler_events")

    plan, strategy = step_artifacts.plan, step_artifacts.strategy
    logger.info("sync_config", sync_mode=plan.sync_mode, grad_compress=plan.grad_compress,
                strategy=strategy.kind, world=strategy.mesh.world)

    # --- init, then resume over it -------------------------------------------
    state = step_artifacts.init(generator)
    resumed_from = None
    start_step = 0
    if ckpt is not None:
        got = ckpt.restore_latest(state)
        if got is not None:
            start_step, state, extra = got
            pipeline.step = int(extra.get("data_step", start_step))
            resumed_from = start_step
            logger.info("resume", f"[loop] resumed from checkpoint step {start_step}",
                        step=start_step)

    preempted = {"flag": False}

    def on_term(sig, frame):
        preempted["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, on_term)
    device = tree_leaves(state["params"])[0].device

    losses: list[float] = []
    ces: list[float] = []
    step_times: list[float] = []
    straggler_events = 0
    nan_skips = 0
    step = start_step
    try:
        while step < loop_cfg.total_steps:
            batch = pipeline.next_sync()
            t0 = time.perf_counter()
            with tracer.span("train.step", step=step):
                state, metrics = step_artifacts.fn(state, batch)
                loss = float(metrics["loss"])  # the one sync: the step is done
            dt = time.perf_counter() - t0
            step_time_h.observe(dt)
            steps_c.inc()
            if tel.enabled or drift is not None:
                mem_bytes, mem_src = obs.device_memory_watermark(device)
                mem_g.set_max(mem_bytes)
            else:
                mem_bytes, mem_src = None, "none"
            if drift is not None:
                drift.observe_step(dt, mem_bytes if mem_bytes else None, mem_source=mem_src)

            if not math.isfinite(loss):
                nan_skips += 1
                nan_c.inc()
                logger.warning("nan_skip",
                               f"[loop] step {step}: non-finite loss ({loss}); skipping batch",
                               step=step, loss=loss)
                if nan_skips > loop_cfg.max_nan_skips:
                    raise FloatingPointError("too many non-finite losses")
                step += 1  # the update ran in place: keep going with it
                continue

            ce = float(metrics["ce"])
            losses.append(loss)
            ces.append(ce)
            loss_g.set(loss)
            step_times.append(dt)
            if len(step_times) >= 5:
                med = statistics.median(step_times[-50:])
                if dt > loop_cfg.deadline_factor * med:
                    straggler_events += 1
                    straggler_c.inc()
                    logger.warning(
                        "straggler", f"[loop] step {step}: straggler ({dt:.3f}s vs median "
                        f"{med:.3f}s)", step=step, dt_s=dt, median_s=med)
            if loop_cfg.log_every and step % loop_cfg.log_every == 0:
                fields = {"step": step, "loss": loss, "ce": ce, "dt_s": dt}
                if "ef_norm" in metrics:
                    fields["ef_norm"] = float(metrics["ef_norm"])
                logger.info("step", f"[loop] step {step} loss={loss:.4f} ce={ce:.4f} "
                            f"({dt * 1e3:.0f} ms)", **fields)
            step += 1

            if ckpt is not None and step % loop_cfg.checkpoint_every == 0:
                with tracer.span("train.checkpoint", step=step):
                    ckpt.save(step, state, extra={"data_step": pipeline.step})
            if preempted["flag"]:
                logger.warning("preempt",
                               "[loop] preemption signal received: final checkpoint + exit",
                               step=step)
                if ckpt is not None:
                    ckpt.save(step, state, extra={"data_step": pipeline.step}, sync=True)
                break
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        if ckpt is not None:
            if not preempted["flag"]:
                ckpt.save(step, state, extra={"data_step": pipeline.step}, sync=True)
            ckpt.wait()

    return LoopResult(steps_run=step - start_step, final_step=step, losses=losses, ces=ces,
                      resumed_from=resumed_from, straggler_events=straggler_events,
                      nan_skips=nan_skips, step_times=step_times, state=state)
