"""Continuous-batching scheduler: requests -> batch slots -> pages.

Host-side bookkeeping only (plain Python, no jax): the decode engine asks the
scheduler each step which token/position every batch slot should decode, and
reports the sampled tokens back. The scheduler

  * admits queued requests into free slots (prompt tokens are then replayed
    through the decode step — teacher-forced prefill, per-slot positions);
  * allocates cache pages lazily as a slot's sequence crosses page
    boundaries, against a bounded ``PagePool`` (the page-table analogue of
    vLLM's block allocator: our physical storage is dense slot-major, the
    pool is the *capacity* ledger the admission policy respects);
  * evicts the youngest running slot back to the queue when the pool runs
    dry (its pages are freed; the request restarts from its prompt later);
  * finishes slots that produced ``max_new_tokens`` (or hit the cache
    length) and frees their pages.

Invariants (property-tested in tests/test_serve_paging.py):
  free pages + pages held by live slots == pool size, with no page held
  twice; every admitted request either finishes exactly once or returns to
  the queue; slot occupancy and page ownership never leak across
  admit/evict/finish cycles.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable

from repro_torch.obs.metrics import NULL_REGISTRY


@dataclasses.dataclass
class Request:
    """Canonical submission form: ``prompt_tokens`` + ``max_new_tokens``.

    ``prompt`` remains as a read alias for the pre-redesign field name
    (positional construction is unchanged).
    """

    rid: int
    prompt_tokens: list[int]  # token ids (at least one)
    max_new_tokens: int

    def __post_init__(self):
        assert len(self.prompt_tokens) >= 1 and self.max_new_tokens >= 1

    @property
    def prompt(self) -> list[int]:
        return self.prompt_tokens


class PagePool:
    """Bounded free-list of physical cache pages."""

    def __init__(self, n_pages: int):
        assert n_pages >= 1
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))
        self._owner: dict[int, int] = {}  # page id -> slot index

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, slot: int, n: int = 1) -> list[int] | None:
        """n pages for ``slot``, or None (and no change) if unavailable."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owner[p] = slot
        return pages

    def free_slot(self, slot: int) -> int:
        """Release every page owned by ``slot``; returns the count."""
        pages = [p for p, s in self._owner.items() if s == slot]
        for p in pages:
            del self._owner[p]
            self._free.append(p)
        return len(pages)

    def held_by(self, slot: int) -> int:
        return sum(1 for s in self._owner.values() if s == slot)


@dataclasses.dataclass
class SlotState:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    length: int = 0  # tokens written to the slot's cache so far
    generated: list[int] = dataclasses.field(default_factory=list)

    @property
    def in_prefill(self) -> bool:
        return self.length < len(self.prompt)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class ContinuousScheduler:
    """Admit/evict/finish requests over ``n_slots`` decode batch slots.

    ``page_size``/``cache_len`` define each slot's page demand: a slot at
    sequence length L holds ceil(L / page_size) pages, capped at the ring
    page count. ``allow_wrap`` (ring caches: sliding-window attention, or
    attention-free state models) lets a slot decode *past* ``cache_len`` —
    the cache ring reuses its slots, so a wrapped slot allocates nothing
    new; without it (full attention) a slot is force-finished when its
    cache slots run out, recorded in ``truncated``.
    """

    def __init__(self, n_slots: int, pool: PagePool, page_size: int,
                 cache_len: int, allow_wrap: bool = False, registry=None):
        assert n_slots >= 1 and page_size >= 1
        self.n_slots = n_slots
        self.pool = pool
        self.page_size = page_size
        self.cache_len = cache_len
        self.allow_wrap = allow_wrap
        self.truncated: set[int] = set()  # rids finished by cache exhaustion
        self.max_pages_per_slot = -(-cache_len // page_size)
        self.queue: deque[Request] = deque()
        self.slots: list[SlotState | None] = [None] * n_slots
        self.finished: dict[int, list[int]] = {}
        self.rejected: dict[int, list[int]] = {}  # page demand > pool capacity
        self.evictions = 0
        # telemetry (obs.MetricsRegistry or the no-op default): request
        # lifecycle counters + PagePool occupancy gauges
        reg = registry if registry is not None else NULL_REGISTRY
        self._c_admitted = reg.counter("serve.admitted")
        self._c_evictions = reg.counter("serve.evictions")
        self._c_finished = reg.counter("serve.finished")
        self._c_rejected = reg.counter("serve.rejected")
        self._c_truncated = reg.counter("serve.truncated")
        self._g_pool_free = reg.gauge("serve.pagepool_free")
        self._g_pool_occ = reg.gauge("serve.pagepool_occupancy")

    def _note_pool(self) -> None:
        free = self.pool.n_free
        self._g_pool_free.set(free)
        self._g_pool_occ.set(1.0 - free / self.pool.n_pages)

    # -- request lifecycle ---------------------------------------------------
    def submit(self, requests: Iterable[Request]) -> None:
        self.queue.extend(requests)

    def _pages_needed(self, length: int) -> int:
        return min(-(-max(length, 1) // self.page_size), self.max_pages_per_slot)

    def admit(self) -> list[int]:
        """Fill free slots from the queue (first page must be allocatable).
        Returns the slot indices admitted this call (engine resets them)."""
        admitted = []
        for b in range(self.n_slots):
            if self.slots[b] is not None or not self.queue:
                continue
            if self.pool.alloc(b, 1) is None:
                break  # no first page -> nothing else will fit either
            req = self.queue.popleft()
            self.slots[b] = SlotState(req.rid, list(req.prompt), req.max_new_tokens)
            admitted.append(b)
        if admitted:
            self._c_admitted.inc(len(admitted))
            self._note_pool()
        return admitted

    def _evict_youngest(self) -> bool:
        """Free the shortest-running slot back to the queue (least replay
        work lost); returns False when nothing is evictable."""
        live = [(b, s) for b, s in enumerate(self.slots) if s is not None]
        if len(live) <= 1:
            return False  # never evict the last runner: no progress otherwise
        b, s = min(live, key=lambda bs: bs[1].length)
        self.pool.free_slot(b)
        self.slots[b] = None
        self.queue.appendleft(Request(s.rid, s.prompt, s.max_new_tokens))
        self.evictions += 1
        self._c_evictions.inc()
        self._note_pool()
        return True

    # -- per-step interface ---------------------------------------------------
    def step_inputs(self, replay_prefill: bool = True
                    ) -> tuple[list[int], list[int], list[bool]]:
        """(token, position, active) per slot for the next decode step.

        Decode slots feed their last sampled token. Prefill slots replay
        their prompt token at the current position when ``replay_prefill``
        (the legacy teacher-forced admission path); with it False (chunked
        prefill owns prompt ingestion) they sit the decode tick out as
        inactive. Inactive slots decode token 0 at position 0 — their output
        is discarded, and the ``active`` mask suppresses their cache writes
        (models.kvcache.write_slot), so mid-prefill slots keep their rows.
        """
        toks, poss, active = [], [], []
        for s in self.slots:
            if s is None or (s.in_prefill and not replay_prefill):
                toks.append(0)
                poss.append(0)
                active.append(False)
                continue
            if s.in_prefill:
                toks.append(s.prompt[s.length])
            else:
                toks.append(s.generated[-1])
            poss.append(s.length)
            active.append(True)
        return toks, poss, active

    def ensure_pages(self, b: int, target_len: int) -> bool:
        """Grow slot ``b``'s page hold to cover ``target_len``, evicting
        youngest runners (never the last) and rejecting outright when the
        demand exceeds the whole pool. Returns True iff the slot survived
        (it may itself be the youngest and get evicted)."""
        s = self.slots[b]
        need = self._pages_needed(target_len)
        while self.slots[b] is not None and self.pool.held_by(b) < need:
            if self.pool.alloc(b, 1) is not None:
                continue
            if not self._evict_youngest():
                # b is the last runner and owns every page: its demand
                # exceeds the pool outright — reject, don't livelock
                self.rejected[s.rid] = list(s.generated)
                self._c_rejected.inc()
                self.pool.free_slot(b)
                self.slots[b] = None
        self._note_pool()
        return self.slots[b] is not None

    def _finish_or_grow(self, b: int) -> None:
        """Post-advance bookkeeping shared by decode ticks and prefill
        chunks: retire done / cache-exhausted slots, else page up for the
        next token write."""
        s = self.slots[b]
        out_of_cache = s.length >= self.cache_len and not self.allow_wrap
        if s.done or out_of_cache:
            self.finished[s.rid] = list(s.generated)
            self._c_finished.inc()
            if out_of_cache and not s.done:
                self.truncated.add(s.rid)
                self._c_truncated.inc()
            self.pool.free_slot(b)
            self.slots[b] = None
            self._note_pool()
            return
        self.ensure_pages(b, s.length + 1)

    def advance(self, sampled: list[int], active: list[bool] | None = None) -> None:
        """Account one decode step: grow lengths, collect samples, finish
        done slots, allocate pages crossed into (evicting on exhaustion).
        ``active`` (the mask ``step_inputs`` returned) skips slots that sat
        the tick out — occupied but mid-chunked-prefill."""
        for b, s in enumerate(self.slots):
            if s is None or (active is not None and not active[b]):
                continue
            s.length += 1
            if s.length >= len(s.prompt):
                # the step consuming the last prompt token (and every one
                # after it) produces a sampled continuation token
                s.generated.append(int(sampled[b]))
            self._finish_or_grow(b)

    # -- chunked-prefill interface -------------------------------------------
    def prefill_slots(self) -> list[int]:
        return [b for b, s in enumerate(self.slots) if s is not None and s.in_prefill]

    def decode_ready(self) -> list[int]:
        """Slots with an in-flight stream a prefill tick would stall."""
        return [b for b, s in enumerate(self.slots)
                if s is not None and not s.in_prefill]

    def should_prefill(self, consec_prefill: int, chunk_budget: int | None) -> bool:
        """Interleaving policy: run a prefill tick next?

        No prefill work -> never. No decode-ready streams to stall (or no
        budget cap) -> always. Otherwise cap consecutive prefill ticks at
        ``chunk_budget`` so no in-flight stream waits more than
        ``chunk_budget`` chunk calls between its tokens (property-tested in
        tests/test_serve_prefill.py)."""
        if not self.prefill_slots():
            return False
        if chunk_budget is None or not self.decode_ready():
            return True
        return consec_prefill < chunk_budget

    def prefill_budget(self, b: int) -> int:
        """Max prompt tokens slot ``b`` may ingest in the next chunk:
        its remaining prompt, clamped at the cache edge for non-wrapping
        (full-attention) caches — mirroring replay truncation."""
        s = self.slots[b]
        remaining = len(s.prompt) - s.length
        if not self.allow_wrap:
            remaining = min(remaining, self.cache_len - s.length)
        return max(0, remaining)

    def advance_prefill(self, fed: list[int], sampled: list[int]) -> None:
        """Account one chunked-prefill call: slot ``b`` ingested ``fed[b]``
        prompt tokens; ``sampled[b]`` is the continuation token its final
        fed token produced (used only when the chunk completes the prompt).
        """
        for b, s in enumerate(self.slots):
            if s is None or not fed[b]:
                continue
            assert s.in_prefill and s.length + fed[b] <= len(s.prompt)
            s.length += fed[b]
            if s.length >= len(s.prompt):
                s.generated.append(int(sampled[b]))
            self._finish_or_grow(b)

    @property
    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)

    def live_slots(self) -> list[int]:
        return [b for b, s in enumerate(self.slots) if s is not None]
