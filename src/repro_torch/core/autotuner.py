"""Automatic memory management (§3.3): constrained configuration search.

Port of ``src/repro/core/autotuner.py``, unchanged in its search: the same
axes, pruning, sweep orders and tie-breaking, so for the same workload and
spec it returns the reference's plan (``tests/test_torch_planner.py``).

    min_{configs} T_iteration   s.t.   M_peak < M_capacity        (Eq. 1)

over configs = {n_persist, n_buffer, n_swap, n_checkpoint} (+ TPU extensions
n_host, microbatch). Pruning mirrors the paper:

  * n_swap is restricted to the bandwidth-feasible set (swap must drain within
    the forward compute window — the N_interval constraint);
  * memory is monotone in n_persist/n_buffer (and anti-monotone in n_host),
    so instead of enumerating we binary-search the largest feasible values —
    the monotone equivalent of "evaluate in increasing memory order and
    discard over-capacity configs early";
  * runtime is monotone-decreasing in n_persist and n_buffer at fixed
    (n_swap, n_checkpoint, microbatch), so maximizing them is optimal per cell.

The search is exhaustive over the remaining axes. All evaluations are analytic
(cost_model) — no training iterations are run, matching the paper's 0.06 s
search overhead claim.

Beyond-paper axes (docs/cost_model.md documents every knob and its units):

  * ``compress`` — gradient-sync wire compression ("auto" by default now that
    the wire factors are calibrated against measured dry-run bytes; see
    benchmarks/calibrate_wire.py and cost_model.wire_factor);
  * per-block activation policies — after the scalar search settles the
    placement axes, ``search_act_policies`` greedily refines the winning
    cell's activation vector over {keep, compress8, remat} ("compress until
    feasible, then buy back latency"); see ACT_LADDER;
  * ``sync`` — who owns the gradient reduction: "xla" (GSPMD's reduce,
    compression is numerics-only) or "manual" (shard_map sync with the
    compressed payload on the wire: DDP-style compressed all-gather for
    fully-replicated layouts, compressed reduce-scatter for ZeRO-sharded
    ones). "manual" candidates are only emitted for plans with a non-None
    ``MemoryPlan.manual_sync_kind`` — exactly what the step builder can
    lower. ZeRO-sharded manual cells emit both dataflows: "zero3" (lazy
    per-chunk gather, true ZeRO-3 param memory — n_persist x n_buffer are
    binary-searched like the xla cells) and "zero2" (up-front gather, no
    re-gathers, ZeRO-2 memory), letting the cost models arbitrate the
    memory-vs-regather trade per workload.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

from repro_torch.core.cost_model import (
    MemoryBreakdown,
    RuntimeBreakdown,
    Workload,
    estimate_memory,
    estimate_runtime,
)
from repro_torch.core.plan import MemoryPlan


@dataclasses.dataclass
class SearchResult:
    plan: MemoryPlan
    runtime: RuntimeBreakdown
    memory: MemoryBreakdown
    evaluated: int
    search_seconds: float
    feasible: bool


def _fits(w: Workload, plan: MemoryPlan, capacity: float) -> bool:
    return estimate_memory(w, plan).peak < capacity


def _max_feasible(lo: int, hi: int, pred) -> int:
    """Largest v in [lo, hi] with pred(v), assuming pred monotone-decreasing.
    Returns lo-1 if none."""
    if not pred(lo):
        return lo - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if pred(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def _grid(n: int, max_points: int = 9) -> list[int]:
    if n <= max_points:
        return list(range(n + 1))
    step = max(1, n // (max_points - 1))
    vals = sorted(set(list(range(0, n + 1, step)) + [n]))
    return vals


# The searched activation-policy ladder, ordered memory-down / latency-up:
# keep everything -> quantize the save sites to int8 -> full remat.
# ``compress16`` is a lattice point the cost model prices but the search
# skips: it moves twice compress8's bytes for the same partial-recompute
# fraction, so it is dominated in (time, memory) — it exists for
# numerics-conservative hand-written plans, not for the optimizer.
ACT_LADDER = ("none", "compress8", "checkpoint")


def search_act_policies(
    w: Workload,
    base: MemoryPlan,
    capacity_bytes: float | None = None,
) -> SearchResult:
    """Greedy per-block activation-policy search under the memory budget.

    The classic "compress until feasible, then buy back latency" sweep over
    the per-block policy vector (MemoryPlan.act_policies), starting from
    ``base``'s lowered vector with every non-swap block on the ladder
    (swap blocks are pinned — their trade is the host link, owned by the
    scalar search):

      phase 1 (degrade, front-to-back — mirroring the n_checkpoint prefix):
        step blocks none -> compress8, then compress8 -> checkpoint, one
        block at a time, stopping at the first feasible vector;
      phase 2 (buy back, back-to-front): upgrade one rung at a time wherever
        the result still fits and the modeled step time does not regress,
        sweeping until a full pass changes nothing.

    Fully deterministic: no tie randomization, fixed sweep orders. Returns
    the vector plan (feasible=False when even remat-all overflows)."""
    t0 = time.time()
    capacity = (capacity_bytes if capacity_bytes is not None
                else w.hw.capacity_bytes())
    vec = list(base.block_policies())
    evaluated = 0

    def mk(v) -> MemoryPlan:
        return dataclasses.replace(
            base, n_swap=0, n_checkpoint=0, act_policies=tuple(v))

    def fits(v) -> bool:
        nonlocal evaluated
        evaluated += 1
        return estimate_memory(w, mk(v)).peak < capacity

    feasible = fits(vec)
    for target in ACT_LADDER[1:]:
        if feasible:
            break
        for b in range(len(vec)):
            if feasible:
                break
            cur = vec[b]
            if (cur not in ACT_LADDER
                    or ACT_LADDER.index(cur) >= ACT_LADDER.index(target)):
                continue
            vec[b] = target
            feasible = fits(vec)

    if feasible:
        best_rt = estimate_runtime(w, mk(vec)).t_iteration
        changed = True
        while changed:
            changed = False
            for b in range(len(vec) - 1, -1, -1):
                cur = vec[b]
                if cur not in ACT_LADDER or cur == "none":
                    continue
                trial = list(vec)
                trial[b] = ACT_LADDER[ACT_LADDER.index(cur) - 1]
                if not fits(trial):
                    continue
                rt = estimate_runtime(w, mk(trial)).t_iteration
                if rt <= best_rt:
                    vec, best_rt, changed = trial, rt, True

    plan = mk(vec)
    res = SearchResult(plan, estimate_runtime(w, plan),
                       estimate_memory(w, plan), evaluated,
                       time.time() - t0, feasible)
    return res


def megatrain_plan(w: Workload, checkpoint_all: bool = True) -> MemoryPlan:
    """MegaTrain-style all-host optimizer tier (PAPERS.md).

    Every chunk rides the ZeRO-Offload split: bf16 param/grad shards stay in
    HBM (gathers ride ICI, not the host link), while the fp32 Adam moments,
    master copy, and the update itself live on host (``host_optimizer`` —
    the existing ``adam_update(host=...)`` tuple in train/step_builder).
    With remat-all this is the minimal-state-footprint plan short of
    activation swapping; the activation axis is then closed by taking the
    smallest gradient-accumulation split (and, only if that is not enough,
    sequence-sharding the boundaries) that fits — which is how 100B-class
    configs plan onto 16 GB chips (the reference's launch/dryrun.py
    --megatrain demonstrates and asserts the fit). Returns the most frugal candidate even when
    nothing fits; callers check estimate_memory themselves."""
    nc, nb = w.n_chunks, w.n_blocks
    seqs = max(int(w.seqs_per_device), 1)
    mbs = [m for m in (1, 2, 4, 8, 16, 32, 64, 128, 256) if m <= seqs]
    plan = None
    for sp in (False, True):
        for mb in mbs:
            plan = MemoryPlan(
                nc, nb, n_persist=0, n_host=nc, host_params=False,
                host_optimizer=True,
                n_checkpoint=nb if checkpoint_all else 0,
                microbatch=mb, seq_shard_acts=sp,
            )
            if _fits(w, plan, w.hw.capacity_bytes()):
                return plan
    return plan


def search(
    w: Workload,
    capacity_bytes: float | None = None,
    *,
    microbatches: tuple[int, ...] = (1, 2, 4, 8, 16),
    allow_host: bool = True,
    allow_swap: bool = True,
    max_checkpoint_points: int = 9,
    sp: str = "off",  # "off" (paper-faithful) | "on" | "auto" (beyond-paper)
    dp: str = "off",  # "off" | "auto": also consider dp_only (model axis -> data)
    # int8+EF gradient-sync wire compression; "auto" by default — the wire
    # factors are calibrated (cost_model.wire_factor), so weighing the knob
    # costs nothing and the search is honest about when compression pays.
    compress: str = "auto",  # "off" | "on" | "auto"
    sync: str = "auto",  # "xla" | "manual" | "auto": who owns the grad reduce
    # comm/compute overlap on the manual path: candidates are priced with the
    # prefetch/deferred-accumulation pipeline on (plan.overlap). Pass False to
    # score the serial manual schedule instead.
    overlap: bool = True,
) -> SearchResult:
    """Find the fastest plan fitting in per-chip memory."""
    t0 = time.time()
    capacity = capacity_bytes if capacity_bytes is not None else w.hw.capacity_bytes()
    nc, nb = w.n_chunks, w.n_blocks
    best: SearchResult | None = None
    evaluated = 0

    sp_vals = {"off": (False,), "on": (True,), "auto": (False, True)}[sp]
    dp_vals = {"off": (False,), "on": (True,), "auto": (False, True)}[dp]
    gc_only = {"off": ("none",), "on": ("int8_ef",), "auto": ("none", "int8_ef")}[compress]
    sync_only = {"xla": ("xla",), "manual": ("manual",), "auto": ("xla", "manual")}[sync]
    # (grad_compress, sync_mode) combos: manual sync without compression has
    # no upside over XLA's native reduce, so it is never proposed
    gc_vals = tuple(
        (gc, sm) for gc in gc_only for sm in sync_only
        if not (gc == "none" and sm == "manual")
    )
    if not gc_vals:
        raise ValueError(
            f"search(compress={compress!r}, sync={sync!r}) leaves nothing to "
            "search: manual sync exists to put compressed payloads on the "
            "wire, so it requires compress != 'off'"
        )

    def dp_view(wl: Workload) -> Workload:
        """Evaluate dp_only plans under a mesh where the model axis has been
        folded into the data axis (tp=1, zero=n_chips_per_pod_axis)."""
        from repro_torch.core.hardware import MeshSpec

        m = wl.mesh
        if "pod" in m.axes:
            new = MeshSpec((m.axis_size("pod"), m.n_chips // m.axis_size("pod")),
                           ("pod", "data"))
        else:
            new = MeshSpec((m.n_chips,), ("data",))
        return dataclasses.replace(wl, mesh=new)

    real_tp = w.mesh.tp_degree  # pre-fold TP: manual eligibility needs it
    for use_dp in dp_vals:
        wl = dp_view(w) if use_dp else w
        if use_dp and w.shape.global_batch % wl.mesh.zero_degree != 0:
            continue  # batch cannot shard over every chip
        seqs = wl.seqs_per_device
        ubs = [m for m in microbatches if seqs / m >= 1 and (seqs / m) % 1 == 0] or [1]
        best, evaluated = _search_inner(
            wl, capacity, ubs, sp_vals, gc_vals, use_dp, real_tp, allow_host,
            allow_swap, max_checkpoint_points, best, evaluated, overlap,
        )
    if best is not None:
        # refine the winning cell's activation axis: the scalar search only
        # saw the uniform n_checkpoint prefixes; the greedy vector sweep can
        # buy back remat latency with compressed saves where capacity allows.
        # Adopted only on a strict improvement, so uniform winners keep their
        # scalar (vector-free) plan representation.
        wl = dp_view(w) if best.plan.dp_only else w
        ref = search_act_policies(wl, best.plan, capacity)
        evaluated += ref.evaluated
        if ref.feasible and ref.runtime.t_iteration < best.runtime.t_iteration:
            best = ref
    if best is None:
        # nothing fits: report the minimal-footprint plan as infeasible
        plan = MemoryPlan(
            nc, nb, n_host=nc if allow_host else 0,
            n_checkpoint=nb, n_swap=0, microbatch=1,
        )
        best = SearchResult(
            plan, estimate_runtime(w, plan), estimate_memory(w, plan), evaluated, 0.0, False
        )
    best.search_seconds = time.time() - t0
    best.evaluated = evaluated
    return best


def _search_inner(w, capacity, ubs, sp_vals, gc_vals, use_dp, real_tp, allow_host,
                  allow_swap, max_checkpoint_points, best, evaluated,
                  overlap=True):
    nc, nb = w.n_chunks, w.n_blocks
    for ub, use_sp, (gc, sync) in itertools.product(ubs, sp_vals, gc_vals):
        manual = sync == "manual"
        if manual and real_tp > 1 and not use_dp:
            continue  # no manual kind lowers with a live TP axis (plan.py)
        # n_swap feasible set (paper: bounded by N_interval & bandwidth);
        # manual sync excludes swap (manual_sync_kind)
        swap_vals = [0]
        if allow_swap and not manual:
            for ns in _grid(nb, 5):
                if ns == 0:
                    continue
                probe = MemoryPlan(nc, nb, n_swap=ns, microbatch=ub,
                                   seq_shard_acts=use_sp, dp_only=use_dp,
                                   grad_compress=gc, sync_mode=sync)
                if estimate_runtime(w, probe).swap_feasible:
                    swap_vals.append(ns)
        for n_swap in swap_vals:
            for n_ckpt in _grid(nb - n_swap, max_checkpoint_points):
              for cg in ((1,) if n_ckpt == 0 else (1, 2, 4)):
               for hp in (True, False):  # full host offload vs ZeRO-Offload split

                def mk(n_persist=0, n_buffer=0, n_host=0, zero_stage=3):
                    return MemoryPlan(
                        nc, nb,
                        n_persist=n_persist, n_buffer=n_buffer, n_host=n_host,
                        n_swap=n_swap, n_checkpoint=n_ckpt, microbatch=ub,
                        seq_shard_acts=use_sp, dp_only=use_dp, ckpt_group=cg,
                        host_params=hp, grad_compress=gc, sync_mode=sync,
                        zero_stage=zero_stage, overlap=overlap,
                    )

                if manual:
                    # manual sync lowers for no-swap/no-host layouts. ZeRO-
                    # sharded chunks sync via the compressed reduce-scatter in
                    # two dataflows: "zero3" (lazy per-chunk gather — true
                    # ZeRO-3 param memory, so n_persist AND n_buffer are
                    # searchable exactly like the xla cells) and "zero2"
                    # (up-front gather: cheapest wire, n_buffer moot because
                    # the body gathers everything). All-persist plans lower
                    # as "ddp" (host_params is moot with zero host chunks).
                    # `evaluated` counts per candidate: one per stage here,
                    # one per cell on the xla branch below.
                    if not hp:
                        continue
                    for stage in (3, 2):
                        evaluated += 1
                        n_persist = _max_feasible(
                            0, nc, lambda v, _s=stage: _fits(
                                w, mk(n_persist=v, zero_stage=_s), capacity))
                        if n_persist < 0:
                            continue
                        plan = mk(n_persist=n_persist, zero_stage=stage)
                        if plan.manual_sync_kind(real_tp) is None:
                            # dp_only with a live TP axis only lowers DDP-
                            # style: the all-persist plan is the one manual
                            # candidate
                            plan = mk(n_persist=nc, zero_stage=stage)
                            if (plan.manual_sync_kind(real_tp) is None
                                    or not _fits(w, plan, capacity)):
                                continue
                        if plan.n_persist == nc:
                            if stage == 2:
                                continue  # same "ddp" plan as the stage-3 pass
                        elif stage == 3:
                            # zero3 re-gathers unbuffered chunks in BWD, so
                            # buffering is a real runtime knob again —
                            # maximize it under capacity (memory monotone)
                            n_buffer = _max_feasible(
                                0, nc - plan.n_persist,
                                lambda v, _p=plan.n_persist: _fits(
                                    w, mk(n_persist=_p, n_buffer=v,
                                          zero_stage=3), capacity))
                            plan = mk(n_persist=plan.n_persist,
                                      n_buffer=max(n_buffer, 0), zero_stage=3)
                        rt = estimate_runtime(w, plan)
                        mem = estimate_memory(w, plan)
                        cand = SearchResult(plan, rt, mem, evaluated, 0.0, True)
                        if best is None or rt.t_iteration < best.runtime.t_iteration:
                            best = cand
                    continue

                evaluated += 1
                # smallest-footprint config in this cell
                if not _fits(w, mk(), capacity):
                    if not allow_host:
                        continue
                    n_host = _max_feasible(1, nc, lambda v: not _fits(w, mk(n_host=v), capacity))
                    n_host = min(n_host + 1, nc)
                    if not _fits(w, mk(n_host=n_host), capacity):
                        continue  # cell infeasible even fully host-offloaded
                else:
                    n_host = 0
                # maximize persistence, then buffering (monotone in memory)
                n_persist = _max_feasible(
                    0, nc - n_host, lambda v: _fits(w, mk(n_persist=v, n_host=n_host), capacity)
                )
                n_persist = max(n_persist, 0)
                n_buffer = _max_feasible(
                    0,
                    nc - n_persist - n_host,
                    lambda v: _fits(w, mk(n_persist=n_persist, n_buffer=v, n_host=n_host), capacity),
                )
                n_buffer = max(n_buffer, 0)
                plan = mk(n_persist=n_persist, n_buffer=n_buffer, n_host=n_host)
                rt = estimate_runtime(w, plan)
                mem = estimate_memory(w, plan)
                if mem.peak >= capacity:
                    continue
                cand = SearchResult(plan, rt, mem, evaluated, 0.0, True)
                if best is None or rt.t_iteration < best.runtime.t_iteration:
                    best = cand
    return best, evaluated


def exhaustive_search(w: Workload, capacity_bytes: float, max_n: int = 6) -> SearchResult:
    """Brute force over the full 4-tuple (tests: validates the pruned search)."""
    t0 = time.time()
    nc, nb = w.n_chunks, w.n_blocks
    assert nc <= max_n + 2 and nb <= max_n + 2, "exhaustive search is for tiny models"
    best = None
    evaluated = 0
    for np_, nh in itertools.product(range(nc + 1), range(nc + 1)):
        if np_ + nh > nc:
            continue
        for nbuf in range(nc - np_ - nh + 1):
            for ns, nk in itertools.product(range(nb + 1), range(nb + 1)):
                if ns + nk > nb:
                    continue
                plan = MemoryPlan(nc, nb, n_persist=np_, n_buffer=nbuf, n_host=nh,
                                  n_swap=ns, n_checkpoint=nk)
                evaluated += 1
                mem = estimate_memory(w, plan)
                if mem.peak >= capacity_bytes:
                    continue
                rt = estimate_runtime(w, plan)
                if not rt.swap_feasible:
                    continue
                if best is None or rt.t_iteration < best.runtime.t_iteration:
                    best = SearchResult(plan, rt, mem, evaluated, 0.0, True)
    if best is None:
        plan = MemoryPlan(nc, nb, n_host=nc, n_checkpoint=nb)
        best = SearchResult(plan, estimate_runtime(w, plan), estimate_memory(w, plan),
                            evaluated, 0.0, False)
    best.search_seconds = time.time() - t0
    best.evaluated = evaluated
    return best
