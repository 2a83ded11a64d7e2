"""Decode engine: continuous batching over a (resident or paged) decode step.

Port of ``src/repro/serve/engine.py``, on one device or on a mesh of data
x model ranks (``mesh``, a ``launch.mesh.LocalMesh``). ``DecodeEngine`` owns
one serving step (a ``serve.prefill.ServeStep`` bound to the engine's state,
over the cache layout ``train.step_builder.serve_layout`` chooses), a
``ContinuousScheduler``
and the live cache. On CUDA the step is captured once as a CUDA graph, and
every decode tick and every step of a prefill chunk replays it
(``graphs``; eager steps are for the CPU and for measuring the graph
against). The request API is the JAX engine's: ``submit`` queues work,
``run`` drives ticks until drained and returns an ``EngineReport``,
``stream`` yields ``TokenEvent``s, ``step_once`` is one tick, ``warmup``
runs the step once on an all-inactive batch.

Each tick the engine

  1. admits queued requests into free batch slots, zeroing their cache rows
     (a Mamba-2 position's conv and ssm state must start from zero: it is
     recurrent; attention rows are masked anyway);
  2. picks prefill or decode (``scheduler.should_prefill``): ``"chunked"``
     admission ingests prompts ``prefill_chunk`` tokens per slot per call,
     interleaved with decode ticks (at most ``chunk_budget`` prefill ticks in
     a row while a stream waits); ``"whole"`` runs the same chunks back to
     back; ``"replay"`` feeds the prompt one token per decode tick;
  3. writes the tick's tokens, positions and counts into the step's
     buffers, runs the step once (decode) or up to ``prefill_chunk`` times
     (prefill), the paged cache's page-boundary flush issued between steps,
     and reads the sampled tokens (greedy argmax on the device) back to the
     host. That read synchronises the CUDA stream, so
     when the next tick's admission zeroes rows of the pinned cold store on
     the host, no kernel or copy that touches it is still queued
     (``paging.assert_stream_idle`` checks this in the reset).

On a mesh every rank runs the same scheduler on the same request stream:
each holds the cache of its slots (``B / data`` where the data ranks
divide B, else every slot) and heads and its weight shards under the plan
(``train.step_builder.serve_layout``), runs the step eagerly, and after
each tick the data ranks' next tokens for their slots are all-gathered
(the argmax over the model group first), so every rank advances its
scheduler identically. ``choose_prefill_chunk`` prices the mesh's spec.
The report's cache bytes and ``h2d_bytes`` are this rank's, beside their
sums over the ranks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterable, Iterator

import torch

from repro_torch import obs
from repro_torch.compat import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.plan import MemoryPlan
from repro_torch.obs.metrics import quantile as _quantile
from repro_torch.serve.paging import (
    PagingSpec,
    assert_stream_idle,
    cache_partition_bytes,
    init_paged_cache,
)
from repro_torch.serve.scheduler import ContinuousScheduler, PagePool, Request


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One generated token, as yielded by ``DecodeEngine.stream``."""

    rid: int
    token: int
    index: int  # position in the request's generated sequence
    finished: bool  # True on the request's final token


@dataclasses.dataclass
class EngineReport:
    steps: int
    generated_tokens: int
    finished: dict[int, list[int]]
    rejected: dict[int, list[int]]
    evictions: int
    wall_s: float
    hbm_cache_bytes: int  # device-resident cache bytes
    host_cache_bytes: int  # host-resident cold pages
    resident_cache_bytes: int  # what the fully resident layout would hold
    drained: bool = True  # False: max_steps hit with requests in flight
    pending: tuple[int, ...] = ()  # rids still queued/running at stop
    truncated: tuple[int, ...] = ()  # rids finished by cache exhaustion
    # -- per-request timing (wall clock) --------------------------------------
    ttft_s: dict[int, float] = dataclasses.field(default_factory=dict)
    request_latency_s: dict[int, float] = dataclasses.field(default_factory=dict)
    itl_s: tuple[float, ...] = ()  # inter-token gaps across all streams
    prefill_ticks: int = 0
    decode_ticks: int = 0
    admission: str = "replay"
    prefill_chunk: int = 0
    # -- on a mesh: the cache fields above are this rank's, the *_ranks the
    # sum over its ranks (each holds the cache of its slots and heads)
    world: int = 1
    h2d_bytes: int = 0  # cold-store bytes this rank's attention read
    h2d_bytes_ranks: int = 0
    hbm_cache_bytes_ranks: int = 0
    host_cache_bytes_ranks: int = 0

    @property
    def hbm_reduction(self) -> float:
        return self.resident_cache_bytes / max(self.hbm_cache_bytes, 1)

    @property
    def p50_latency_s(self) -> float:
        return _quantile(list(self.request_latency_s.values()), 0.50)

    @property
    def p99_latency_s(self) -> float:
        return _quantile(list(self.request_latency_s.values()), 0.99)

    @property
    def p50_ttft_s(self) -> float:
        return _quantile(list(self.ttft_s.values()), 0.50)

    @property
    def p99_ttft_s(self) -> float:
        return _quantile(list(self.ttft_s.values()), 0.99)

    @property
    def p99_itl_s(self) -> float:
        return _quantile(list(self.itl_s), 0.99)

    def to_dict(self) -> dict:
        """The flat JSON form of the JAX engine's report."""
        return {
            "admission": self.admission,
            "prefill_chunk": self.prefill_chunk,
            "drained": self.drained,
            "steps": self.steps,
            "prefill_ticks": self.prefill_ticks,
            "decode_ticks": self.decode_ticks,
            "generated_tokens": self.generated_tokens,
            "finished_requests": len(self.finished),
            "evictions": self.evictions,
            "truncated": len(self.truncated),
            "rejected": len(self.rejected),
            "wall_s": self.wall_s,
            "tokens_per_s": self.generated_tokens / max(self.wall_s, 1e-9),
            "p50_latency_s": self.p50_latency_s,
            "p99_latency_s": self.p99_latency_s,
            "p50_ttft_s": self.p50_ttft_s,
            "p99_ttft_s": self.p99_ttft_s,
            "p99_itl_s": self.p99_itl_s,
            **({} if self.world == 1 else {
                "world": self.world, "h2d_bytes_rank": self.h2d_bytes,
                "h2d_bytes_ranks": self.h2d_bytes_ranks,
                "hbm_cache_bytes_rank": self.hbm_cache_bytes,
                "hbm_cache_bytes_ranks": self.hbm_cache_bytes_ranks,
                "host_cache_bytes_rank": self.host_cache_bytes,
                "host_cache_bytes_ranks": self.host_cache_bytes_ranks}),
        }


def _zero_slots(cache: dict, slots: list[int]) -> None:
    """Zero every cache leaf's rows of ``slots`` in place. Leaves carry the
    batch dim at axis 1 -- (R, B, ...) -- for resident and paged layouts."""
    assert_stream_idle(cache)
    for entry in cache.values():
        for leaf in entry.values():
            leaf[:, slots] = 0


def _tree_to(tree: dict, device: torch.device, copy: bool) -> dict:
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, copy) for k, v in tree.items()}
    out = tree.to(device)
    return out.clone() if copy and out.data_ptr() == tree.data_ptr() else out


class DecodeEngine:
    """``admission``: ``"chunked"`` (default), ``"whole"`` or ``"replay"``.
    ``prefill_chunk`` under chunked or whole admission: None takes the cost
    model's choice (``core.cost_model.choose_prefill_chunk``) on ``hw``,
    by default this card's spec (``core.hardware.local_cuda_hw``) on CUDA
    and ``LOCAL_CPU_HW`` on the CPU. ``chunk_budget`` caps consecutive prefill ticks while
    decode-ready streams wait (None = unbounded). ``device`` is where the
    step runs: ``None`` means CUDA, and raises where there is none.
    ``graphs``: replay the step from a CUDA graph; ``None`` means yes on
    CUDA and no on the CPU, and ``True`` on the CPU raises. ``mesh``:
    serve on its ranks (``device`` is then the mesh's); ``params`` is the
    whole tree, of which each rank keeps its shards; graphs stay off
    there, and ``graphs=True`` raises."""

    def __init__(
        self,
        cfg: ModelConfig,
        plan: MemoryPlan,
        device,
        shape: ShapeConfig,
        params: Any,
        *,
        paging: PagingSpec | None = None,
        own_params: bool = False,
        admission: str | None = None,
        prefill_chunk: int | None = None,
        chunk_budget: int | None = 1,
        hw=None,
        telemetry: obs.Telemetry | None = None,
        graphs: bool | None = None,
        mesh=None,
    ):
        from repro_torch.models import kvcache as KVC
        from repro_torch.serve.prefill import ServeStep
        from repro_torch.train import step_builder as SB

        if mesh is not None and device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device}, but the mesh's is {mesh.device}")
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.mesh = mesh
        self.cfg, self.shape = cfg, shape
        tel = telemetry if telemetry is not None else obs.current_telemetry()
        if not tel.enabled:
            tel = obs.Telemetry(trace=False)
        self.tel = tel
        if admission is None:
            admission = "replay" if cfg.attention_free else "chunked"
        if admission not in ("replay", "chunked", "whole"):
            raise ValueError(f"admission {admission!r}")
        self.admission = admission
        self.chunk_budget = None if admission == "whole" else chunk_budget

        cache_len = KVC.cache_len(cfg, shape.seq_len)
        self.layout = layout = SB.serve_layout(cfg, plan, shape, paging, mesh)
        paging, self.kv_io = layout.paging, layout.kv_io
        self.paging = paging
        if admission != "replay":
            if prefill_chunk is None:
                from repro_torch.core.cost_model import choose_prefill_chunk
                from repro_torch.core.hardware import LOCAL_CPU_HW, ONE_CHIP, local_cuda_hw

                on_cuda = self.device.type == "cuda"
                if hw is None:
                    hw = local_cuda_hw(self.device) if on_cuda else LOCAL_CPU_HW
                prefill_chunk = choose_prefill_chunk(
                    cfg, shape, ONE_CHIP if mesh is None else mesh.spec, hw, spec=paging,
                    max_chunk=paging.page_size if paging else cache_len, kernel=on_cuda)
            self.prefill_chunk = max(1, min(int(prefill_chunk), cache_len))
        else:
            self.prefill_chunk = 0
        if graphs is None:
            graphs = self.device.type == "cuda" and layout.world == 1
        # the step writes the cache in place; the engine owns its parameter
        # copies unless ownership was handed over (own_params=True); on a
        # mesh it keeps this rank's shards
        params = layout.shard(_tree_to(params, self.device, copy=not own_params))
        slots = layout.slots[1]
        if paging is None:
            cache = KVC.init_cache(cfg, slots, shape.seq_len, self.device, layout.tp)
        else:
            cache = init_paged_cache(cfg, slots, shape.seq_len, paging, self.device, layout.tp)
        self.state = {"params": params, "cache": cache}
        self.serve_step = ServeStep(params, cache, cfg, self.kv_io,
                                    batch=shape.global_batch, chunk=max(1, self.prefill_chunk),
                                    device=self.device, graph=graphs, layout=layout,
                                    gather=layout.gather(params, tel.registry))

        page_size = paging.page_size if paging else cache_len
        n_pages_per_slot = -(-cache_len // page_size)
        self.scheduler = ContinuousScheduler(
            n_slots=shape.global_batch,
            pool=PagePool(n_pages_per_slot * shape.global_batch),
            page_size=page_size,
            cache_len=cache_len,
            # ring caches (SWA) decode past the cache length by slot reuse;
            # full attention runs out of slots there
            allow_wrap=bool(cfg.sliding_window) or cfg.attention_free,
            registry=tel.registry,
        )
        reg = tel.registry
        self._c_ticks = reg.counter("serve.ticks")
        self._c_prefill_ticks = reg.counter("serve.ticks", phase="prefill")
        self._c_decode_ticks = reg.counter("serve.ticks", phase="decode")
        self._c_gen = reg.counter("serve.generated_tokens")
        self._h_itl = reg.histogram("serve.itl_s")
        # cold-store bytes attention read (the host-link bytes on CUDA), from
        # the step's cache hook after every tick
        self._c_h2d = reg.counter("serve.h2d_bytes")
        self._h2d_seen = self._h2d_total()
        self._consec_prefill = 0
        self._t0: float | None = None
        self._t_submit: dict[int, float] = {}
        self._t_first: dict[int, float] = {}
        self._t_finish: dict[int, float] = {}
        self._t_last_tok: dict[int, float] = {}
        self._gen_count: dict[int, int] = {}
        self._itl: list[float] = []

    # -- registry-backed tick accounting --------------------------------------
    @property
    def ticks(self) -> int:
        return int(self._c_ticks.value)

    @property
    def prefill_ticks(self) -> int:
        return int(self._c_prefill_ticks.value)

    @property
    def decode_ticks(self) -> int:
        return int(self._c_decode_ticks.value)

    def _h2d_total(self) -> int:
        return getattr(self.kv_io, "h2d_bytes", 0)

    # -- request API ---------------------------------------------------------
    def warmup(self) -> None:
        """Run the step once with an all-inactive batch -- the active mask
        suppresses every cache write, so live state is untouched. On CUDA
        this builds and loads the kernels (the graph's capture already has)."""
        step = self.serve_step
        step.n_tok.zero_()
        step.t.zero_()
        step.replay_once()
        step.next_tok.cpu()  # synchronise
        self._h2d_seen = self._h2d_total()  # warm-up reads are not served traffic

    def submit(self, requests: Iterable[Request]) -> None:
        """Queue requests; admission happens on subsequent ticks."""
        now = time.time()
        if self._t0 is None:
            self._t0 = now
        reqs = list(requests)
        self.scheduler.submit(reqs)
        for r in reqs:
            self._t_submit.setdefault(r.rid, now)

    def step_once(self) -> None:
        """One engine tick: admit, then one prefill chunk or one decode step."""
        sched = self.scheduler
        admitted = sched.admit()
        first, n = self.layout.slots
        mine = [b - first for b in admitted if first <= b < first + n]
        if mine:
            _zero_slots(self.state["cache"], mine)
        if (self.prefill_chunk
                and sched.should_prefill(self._consec_prefill, self.chunk_budget)):
            with self.tel.tracer.span("serve.prefill_tick"):
                self._prefill_tick()
            self._consec_prefill += 1
        else:
            with self.tel.tracer.span("serve.decode_tick"):
                self._decode_tick()
            self._consec_prefill = 0
        self._c_ticks.inc()
        h2d = self._h2d_total()
        self._c_h2d.inc(h2d - self._h2d_seen)
        self._h2d_seen = h2d
        self._note_progress()

    def run(self, requests: Iterable[Request] | None = None,
            max_steps: int = 10_000) -> EngineReport:
        """Drive ticks until drained (or ``max_steps``); returns the report."""
        if requests is not None:
            self.submit(requests)
        sched = self.scheduler
        steps = 0
        while not sched.idle and steps < max_steps:
            self.step_once()
            steps += 1
        return self.report(steps=steps)

    def stream(self, requests: Iterable[Request] | None = None,
               max_steps: int = 10_000) -> Iterator[TokenEvent]:
        """Tick the engine, yielding each generated token as a TokenEvent, in
        tick order, interleaved across requests. An evicted request's
        replayed tokens are not re-emitted."""
        if requests is not None:
            self.submit(requests)
        sched = self.scheduler
        emitted: dict[int, int] = {}

        def drain() -> Iterator[TokenEvent]:
            live = {s.rid: (s.generated, False) for s in sched.slots if s is not None}
            done = {rid: (toks, True) for rid, toks in sched.finished.items()}
            for rid, (toks, fin) in {**live, **done}.items():
                start = emitted.get(rid, 0)
                for i in range(start, len(toks)):
                    yield TokenEvent(rid, int(toks[i]), i, fin and i == len(toks) - 1)
                emitted[rid] = max(start, len(toks))

        steps = 0
        while not sched.idle and steps < max_steps:
            self.step_once()
            steps += 1
            yield from drain()

    # -- internal ticks -------------------------------------------------------
    def _run_step(self, toks: list[list[int]], pos: list[int], n_tok: list[int]) -> list[int]:
        """The step over a (B, chunk) block of tokens; the sampled tokens.
        The read-back synchronises the stream (see the module docstring)."""
        chunk = self.serve_step.chunk
        self.serve_step.run([row + [0] * (chunk - len(row)) for row in toks], pos, n_tok)
        return self.serve_step.next_tok.cpu().tolist()

    def _decode_tick(self) -> None:
        sched = self.scheduler
        toks, poss, active = sched.step_inputs(replay_prefill=self.admission == "replay")
        if not any(active):
            return  # every occupied slot is mid-prefill: nothing to decode
        nxt = self._run_step([[t] for t in toks], poss, [int(a) for a in active])
        sched.advance(nxt, active)
        self._c_decode_ticks.inc()

    def _prefill_tick(self) -> None:
        sched = self.scheduler
        chunk = self.prefill_chunk
        bsz = self.shape.global_batch
        # page up BEFORE any cache write, so pool-pressure evictions and
        # rejections land before the chunk runs
        for b in list(sched.prefill_slots()):
            s = sched.slots[b]
            if s is None:
                continue
            sched.ensure_pages(b, s.length + min(chunk, sched.prefill_budget(b)))
        # assemble AFTER all ensures: an ensure may have evicted another slot
        toks = [[0] * chunk for _ in range(bsz)]
        pos = [0] * bsz
        n_tok = [0] * bsz
        for b in sched.prefill_slots():
            s = sched.slots[b]
            n_b = min(chunk, sched.prefill_budget(b))
            if n_b <= 0:
                continue
            toks[b][:n_b] = s.prompt[s.length:s.length + n_b]
            pos[b] = s.length
            n_tok[b] = n_b
        if not any(n_tok):
            return
        sched.advance_prefill(n_tok, self._run_step(toks, pos, n_tok))
        self._c_prefill_ticks.inc()

    # -- timing ---------------------------------------------------------------
    def _note_progress(self) -> None:
        now = time.time()
        sched = self.scheduler
        counts = {rid: len(toks) for rid, toks in sched.finished.items()}
        counts.update({s.rid: len(s.generated) for s in sched.slots if s is not None})
        for rid, n in counts.items():
            seen = self._gen_count.get(rid, 0)
            if n > seen:
                self._c_gen.inc(n - seen)
                if rid not in self._t_first and rid in self._t_submit:
                    self._t_first[rid] = now
                if rid in self._t_last_tok:
                    gap = now - self._t_last_tok[rid]
                    self._itl.append(gap)
                    self._h_itl.observe(gap)
                self._t_last_tok[rid] = now
                self._gen_count[rid] = n
            elif n < seen:
                self._gen_count[rid] = n  # evicted: replaying from scratch
        for rid in sched.finished:
            self._t_finish.setdefault(rid, now)
        for rid in sched.rejected:
            self._t_finish.setdefault(rid, now)

    # -- reporting -------------------------------------------------------------
    def report(self, steps: int | None = None) -> EngineReport:
        """Metrics snapshot, callable mid-flight; at a world above one every
        rank calls it (``run`` does): it sums the ranks' cold-store bytes."""
        sched = self.scheduler
        slots, tp = self.layout.slots[1], self.layout.tp
        parts = cache_partition_bytes(self.cfg, slots, self.shape.seq_len, self.paging, tp)
        resident = cache_partition_bytes(self.cfg, slots, self.shape.seq_len, None, tp)
        pending = tuple(sorted({r.rid for r in sched.queue}
                               | {s.rid for s in sched.slots if s is not None}))
        t0 = self._t0 if self._t0 is not None else time.time()
        latency = {rid: self._t_finish[rid] - self._t_submit[rid]
                   for rid in self._t_finish if rid in self._t_submit}
        ttft = {rid: self._t_first[rid] - self._t_submit[rid]
                for rid in self._t_first if rid in self._t_submit}
        # the kernel path attends over hot ring + cold store in place: no
        # gathered transient exists on the device
        transient = 0 if getattr(self.kv_io, "use_kernel", False) else parts["transient"]
        world = self.layout.world
        h2d = int(self._c_h2d.value)
        h2d_ranks = h2d
        if world > 1:  # every rank reports (run does): the ranks' sum
            total = torch.tensor([float(h2d)], dtype=torch.float64, device=self.device)
            torch.distributed.all_reduce(total, group=self.mesh.group)
            h2d_ranks = int(total.item())
        return EngineReport(
            drained=sched.idle,
            pending=pending,
            truncated=tuple(sorted(sched.truncated)),
            steps=self.ticks if steps is None else steps,
            generated_tokens=sum(len(v) for v in sched.finished.values()),
            finished=dict(sched.finished),
            rejected=dict(sched.rejected),
            evictions=sched.evictions,
            wall_s=time.time() - t0,
            hbm_cache_bytes=parts["hbm"] + transient,
            host_cache_bytes=parts["host"],
            resident_cache_bytes=resident["hbm"],
            ttft_s=ttft,
            request_latency_s=latency,
            itl_s=tuple(self._itl),
            prefill_ticks=self.prefill_ticks,
            decode_ticks=self.decode_ticks,
            admission=self.admission,
            prefill_chunk=self.prefill_chunk,
            world=world,
            h2d_bytes=h2d,
            h2d_bytes_ranks=h2d_ranks,
            hbm_cache_bytes_ranks=world * (parts["hbm"] + transient),
            host_cache_bytes_ranks=world * parts["host"],
        )
