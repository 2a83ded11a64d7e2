"""MemoryPlan: the compact configuration space ProTrain searches (§3.3).

The paper's tunables {n_persist, n_buffer, n_swap, n_checkpoint} plus the
TPU-hierarchy extension ``n_host`` (non-persistent chunks whose shards live in
host memory rather than HBM — the analogue of the paper's CPU offload of
parameters/optimizer states, generalized because a v5e chip has only 16 GB)
and ``microbatch`` (gradient accumulation splits, which the memory model needs
to reason about activation footprints at large global batches).

Chunk i (execution order) is treated as:
  i <  n_persist                  -> persistent: replicated over ZeRO axes
  n_persist <= i < N - n_host     -> ZeRO-sharded, shards resident in HBM
  i >= N - n_host                 -> ZeRO-sharded, shards resident in host mem
Block b (one per chunk; chunk == superblock == transformer block group):
  b <  n_swap                     -> "swap": block-interior activations are
                                     offloaded to host (jax.checkpoint offload
                                     policy); the block boundary (the scan
                                     carry) stays on device — a documented TPU
                                     adaptation: XLA scan AD owns the carries
  n_swap <= b < n_swap + n_ckpt   -> gradient checkpointing (remat)
  otherwise                       -> unoptimized (keep activations)
The scalar {n_swap, n_checkpoint} boundary is a *lowering*: it describes the
uniform prefix layouts the paper searches. ``act_policies`` generalizes it to
an explicit per-block policy vector over
{none|checkpoint|swap|compress8|compress16} (aliases keep->none,
remat->checkpoint accepted), making the activation axis a searched dimension
like placement — the compress entries save activations through the
quantize-on-save custom_vjp (models/model.compress_act) instead of holding
full precision or recomputing. When ``act_policies`` is None every existing
plan keeps its scalar-knob semantics unchanged.
Buffers: the last ``n_buffer`` non-persistent chunks keep their *gathered*
weights live from forward to backward (no re-gather in BWD) — the analogue of
chunk-buffer reuse; the backward pass visits those chunks first, which is
exactly the paper's motivation for placing persistent chunks at the front.

Swap blocks are placed earliest (paper Fig. 2: more time to overlap), then
checkpoint blocks, then unoptimized blocks last so their activations are
consumed first in BWD.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    n_chunks: int  # N_chunk (model-state chunks == superblocks + embed/head)
    n_blocks: int  # N_block (activation blocks == superblocks)
    n_persist: int = 0
    n_buffer: int = 0
    n_swap: int = 0
    n_checkpoint: int = 0
    n_host: int = 0  # non-persistent chunks offloaded to host memory
    microbatch: int = 1  # gradient-accumulation splits of the global batch
    host_optimizer: bool = True  # host chunks update off-device (CPU-Adam analogue)
    zero1_persistent: bool = False  # beyond-paper: shard opt state of persistent chunks
    # beyond-paper: shard block-boundary activations over the TP axis
    # (Megatron-style sequence parallelism); the paper-faithful baseline keeps
    # boundaries replicated across TP like its GPU implementation does.
    seq_shard_acts: bool = False
    # beyond-paper: repurpose the model axis as an extra data axis (weights
    # replicated across it, batch sharded over it). Kills the Megatron TP
    # activation all-reduces that dominate small models on a fixed
    # (data, model) production mesh. Requires global_batch % n_chips == 0.
    dp_only: bool = False
    # beyond-paper: checkpoint granularity — remat regions of `ckpt_group`
    # consecutive layers instead of one. Saves 1/g of the boundary
    # activations at the cost of g-layer recompute working sets (the
    # classic sqrt(n) rematerialization trade, Chen et al. 2016).
    ckpt_group: int = 1
    # host-chunk layout: True = paper-faithful full offload (params + states on
    # host; gathers ride the host link every microbatch). False = ZeRO-Offload
    # split: bf16 param/grad shards stay in HBM (gathers ride ICI), only the
    # fp32 optimizer states live on host and round-trip once per step.
    host_params: bool = True
    # beyond-paper: gradient-sync wire compression (repro.dist.collectives).
    # "none" keeps XLA's native reduction; "bf16" forces a bf16 wire format;
    # "int8_ef" quantizes to int8 with error-feedback residuals carried in the
    # train state (fp32 per-param, accounted by the memory model).
    grad_compress: str = "none"
    # who owns the gradient reduction (see docs/architecture.md):
    #   "xla"    — GSPMD inserts the reduce; grad_compress applies the wire
    #              *numerics* to the already-reduced grads (wire bytes
    #              unchanged — calibration measures factor ~1.0);
    #   "manual" — the step builder wraps loss/grad in a shard_map over the
    #              batch axes and owns the sync: local grads are quantized and
    #              the compressed payload crosses the wire (real byte
    #              savings). Replicated layouts sync DDP-style (compressed
    #              all-gather); ZeRO-sharded layouts reduce-scatter the
    #              compressed payload to shard owners; see manual_sync_kind().
    sync_mode: str = "xla"
    # manual-sync ZeRO dataflow for sharded plans (ignored otherwise):
    #   3 — lazy per-chunk gather: each chunk's bf16 params are all-gathered
    #       just-in-time inside the layer scan through a custom-vjp gather
    #       whose transpose IS the compressed reduce-scatter, so full params
    #       never coexist and n_buffer keeps its xla-path meaning (buffered
    #       chunks hold gathered weights FWD->BWD, unbuffered ones re-gather
    #       in BWD);
    #   2 — legacy up-front gather: full bf16 params live for the whole step
    #       (ZeRO-2-style memory), no re-gathers.
    zero_stage: int = 3
    # comm/compute overlap on the manual path (docs/cost_model.md §2):
    #   True  — the step builder pipelines the zero3 lazy gathers (chunk k+1's
    #           all-gather issued during chunk k's matmuls, barrier-ordered
    #           like serve/paging's double buffer — needs n_buffer >= 2, see
    #           gather_prefetch_depth), defers each microbatch's gradient
    #           accumulate so the reduce-scatter overlaps the next backward,
    #           and issues host param fetches before the layer scan; the cost
    #           model prices per-chunk comm as max(compute, comm);
    #   False — everything runs inline and the cost model prices comm serially
    #           (sum) — the pre-overlap baseline the benchmarks compare to.
    # The xla path ignores this knob: GSPMD's scheduler owns overlap there.
    overlap: bool = True
    # Per-block activation policy vector (tentpole of the adaptive-activation
    # PR): entry b in {"none","checkpoint","swap","compress8","compress16"}
    # decides what block b saves for backward. None (default) lowers the
    # scalar {n_swap, n_checkpoint} prefix knobs to the uniform vector via
    # block_policy(), so every pre-vector plan is unchanged. Aliases
    # "keep"->"none" and "remat"->"checkpoint" are normalized on construction.
    # Setting a vector requires the scalar knobs stay 0 (one source of truth).
    act_policies: tuple[str, ...] | None = None

    #: policies block_policy() may return / act_policies may contain
    ACT_POLICIES = ("none", "checkpoint", "swap", "compress8", "compress16")
    _ACT_ALIASES = {"keep": "none", "remat": "checkpoint"}

    @property
    def gather_prefetch_depth(self) -> int:
        """Gather buffers the zero3 prefetch pipeline may hold in flight.

        2 (double-buffered: prefetch + execute) when overlap is on, the plan
        syncs manually at zero_stage 3, and ``n_buffer >= 2`` gives the remat
        policy room to keep both gathered chunks live; 1 (serial, gather at
        point of use) otherwise — the documented serial fallback for
        ``n_buffer < 2``.
        """
        if (self.overlap and self.sync_mode == "manual"
                and self.zero_stage == 3 and self.n_buffer >= 2):
            return 2
        return 1

    def __post_init__(self):
        assert 0 <= self.n_persist <= self.n_chunks
        assert 0 <= self.n_buffer <= self.n_chunks - self.n_persist
        # Training plans bound n_host by the non-persistent chunk count.
        # Serving plans overload n_host as "KV-cache pages offloaded to host"
        # (core/serve_plan.py), which is legal alongside n_persist == n_chunks
        # because chunk_placement checks persistence first — the weight stack
        # stays persistent while the page count rides in n_host.
        assert self.n_host >= 0
        assert (self.n_host <= self.n_chunks - self.n_persist
                or self.n_persist == self.n_chunks)
        assert 0 <= self.n_swap + self.n_checkpoint <= self.n_blocks
        assert self.microbatch >= 1
        assert self.grad_compress in ("none", "bf16", "int8_ef"), self.grad_compress
        assert self.sync_mode in ("xla", "manual"), self.sync_mode
        assert self.zero_stage in (2, 3), self.zero_stage
        if self.act_policies is not None:
            pols = tuple(self._ACT_ALIASES.get(p, p) for p in self.act_policies)
            object.__setattr__(self, "act_policies", pols)
            assert len(pols) == self.n_blocks, (len(pols), self.n_blocks)
            for p in pols:
                assert p in self.ACT_POLICIES, p
            # the vector replaces the scalar prefix knobs — both set is
            # ambiguous, so the constructor refuses it
            assert self.n_swap == 0 and self.n_checkpoint == 0, (
                "act_policies replaces n_swap/n_checkpoint; keep them 0")

    # ---- n_host facade ----------------------------------------------------
    # ``n_host`` is overloaded: training plans count host-offloaded parameter
    # chunks; serve plans (n_persist == n_chunks, core/serve_plan.py) count
    # cold KV-cache pages. These accessors are the canonical reads — call
    # sites that use them survive the planned split of the field into
    # per-resource host budgets (ROADMAP) without edits.
    @property
    def host_param_chunks(self) -> int:
        """Parameter chunks whose shards live in host memory (0 for serve
        plans, where n_host counts cache pages instead)."""
        return self.n_host if self.n_persist < self.n_chunks else 0

    @property
    def cold_kv_pages(self) -> int:
        """Host-resident KV-cache pages of a serve plan (0 for training
        plans, where n_host counts parameter chunks instead)."""
        return self.n_host if self.n_persist == self.n_chunks else 0

    # ---- manual gradient sync eligibility ---------------------------------
    def manual_sync_kind(self, tp_degree: int = 1) -> str | None:
        """Which manual shard_map sync pipeline this plan lowers to, if any.

        Returns:
          * ``"ddp"``   — fully-replicated layout: the body computes per-device
            gradients with replicated parameter specs and syncs them with a
            compressed all-gather over the batch axes (DDP-style).
          * ``"zero2"`` — ZeRO-sharded layout, ``zero_stage=2``: the body
            gathers the bf16 param shards up front (full bf16 params live for
            the step, fp32 optimizer states and the synced gradient stay
            shard-resident), then reduce-scatters the compressed local
            gradients so each device owns its shard's reduced gradient and
            updates it in place.
          * ``"zero3"`` — ZeRO-sharded layout, ``zero_stage=3`` (default):
            same shard-resident state and compressed reduce-scatter, but each
            chunk's bf16 params are gathered lazily inside the layer scan via
            a custom-vjp all-gather whose transpose is the reduce-scatter —
            full params never coexist, restoring true ZeRO-3 param memory;
            ``n_buffer`` decides which chunks keep gathered weights FWD->BWD.
          * ``None``    — cannot lower manually; ``sync_mode="manual"`` raises.

        Shared requirements (all kinds):

          * no activation swapping (host-offload remat policies reference
            memory kinds that cannot be named inside a shard_map body);
          * no host-resident chunks (same memory-kind constraint).

        Kind-specific:

          * "ddp" additionally needs replicated fp32 optimizer states (no
            zero1_persistent) and tp_degree == 1 unless dp_only repurposes
            the model axis as a batch axis;
          * "zero2"/"zero3" need tp_degree == 1 outright (with a real model
            axis the ZeRO shard axes and the batch/sync axes differ — dp_only
            shards the batch over the model axis too, but parameters still
            shard over the ZeRO axes only, so the reduce-scatter owner
            coordinate would not match the storage layout) and no
            zero1_persistent (persistent chunks keep replicated updates).

        Ineligible plans keep ``sync_mode="xla"`` semantics; the autotuner
        only proposes "manual" for plans with a non-None kind.
        """
        if ("swap" in self.block_policies() or self.host_param_chunks > 0
                or self.zero1_persistent):
            return None
        if self.n_persist == self.n_chunks:
            return "ddp" if (tp_degree == 1 or self.dp_only) else None
        if tp_degree != 1:
            return None
        return "zero3" if self.zero_stage == 3 else "zero2"

    def manual_sync_ok(self, tp_degree: int = 1) -> bool:
        """True when the plan lowers manually at all (any kind)."""
        return self.manual_sync_kind(tp_degree) is not None

    # ---- block policy ----------------------------------------------------
    def block_policy(self, b: int) -> str:
        if self.act_policies is not None:
            return self.act_policies[b]
        if b < self.n_swap:
            return "swap"
        if b < self.n_swap + self.n_checkpoint:
            return "checkpoint"
        return "none"

    def block_policies(self) -> list[str]:
        return [self.block_policy(b) for b in range(self.n_blocks)]

    def compressed_blocks(self) -> int:
        """How many blocks save through the quantize-on-save seam."""
        return sum(p in ("compress8", "compress16") for p in self.block_policies())

    # ---- chunk placement ---------------------------------------------------
    def chunk_placement(self, i: int) -> str:
        """persist | hbm | host, for chunk i in execution order."""
        if i < self.n_persist:
            return "persist"
        if i >= self.n_chunks - self.host_param_chunks:
            return "host"
        return "hbm"

    def chunk_buffered(self, i: int) -> bool:
        """Gathered weights of chunk i kept live FWD->BWD?"""
        if self.chunk_placement(i) == "persist":
            return True  # persistent chunks are always resident
        return i >= self.n_chunks - self.n_buffer

    def describe(self) -> str:
        comp = "" if self.grad_compress == "none" else f" comm={self.grad_compress}"
        if self.sync_mode != "xla":
            comp += f" sync={self.sync_mode}"
            comp += f" zstage={self.zero_stage}"
            comp += f" overlap={'on' if self.overlap else 'off'}"
        if self.ckpt_group != 1:
            comp += f" ckptg={self.ckpt_group}"
        if self.act_policies is not None:
            runs, prev = [], None
            for p in self.act_policies:
                if prev is not None and p == prev[0]:
                    prev[1] += 1
                else:
                    prev = [p, 1]
                    runs.append(prev)
            comp += " acts=" + ",".join(
                p if n == 1 else f"{p}x{n}" for p, n in runs)
        return (
            f"persist={self.n_persist}/{self.n_chunks} buffer={self.n_buffer} "
            f"host={self.n_host} swap={self.n_swap} ckpt={self.n_checkpoint} "
            f"ubatch={self.microbatch}{comp}"
        )


def fully_resident_plan(n_chunks: int, n_blocks: int) -> MemoryPlan:
    """Everything persistent, no remat/swap — the small-model fast path."""
    return MemoryPlan(n_chunks=n_chunks, n_blocks=n_blocks, n_persist=n_chunks, n_host=0)


def fsdp_style_plan(n_chunks: int, n_blocks: int, checkpoint_all: bool = True) -> MemoryPlan:
    """Paper baseline: FSDP = everything sharded, checkpoint all-or-nothing."""
    return MemoryPlan(
        n_chunks=n_chunks,
        n_blocks=n_blocks,
        n_persist=0,
        n_buffer=0,
        n_checkpoint=n_blocks if checkpoint_all else 0,
    )
