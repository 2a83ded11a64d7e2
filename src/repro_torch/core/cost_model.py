"""Runtime + peak-memory cost models (paper Appendix A).

Port of ``src/repro/core/cost_model.py``: the same terms, units and
arithmetic, so the port's planner prices a plan exactly as the reference
does (``tests/test_torch_planner.py`` holds the two equal to 1e-12 on a
shared profile). Both models are functions of a ``MemoryPlan`` over a
``Workload``; one profiling pass (``core/profiler.py``) feeds every
candidate evaluation.

Runtime (Eq. 2-7): per-chunk max(compute, communication) pipelines for FWD
and BWD, the host-update overlap, and host-link contention between
activation swapping and parameter uploads. Memory (Eq. 8-11): block-granular
replay of the FWD/BWD trajectory. The multi-chip terms (gathers, reduces,
the manual sync kinds) are plain arithmetic and come along unchanged.

Gradient-sync wire factors default to the analytic table below; a
calibration JSON overrides them (``load_wire_calibration``: the packaged
``wire_calibration.json``, a copy of the reference's, or
``$REPRO_WIRE_CALIBRATION``). Its backend key is ``"cuda"`` when torch sees
a card, else ``"cpu"``, falling back to the first entry as the reference
does; the packaged file has only ``"cpu"``, so both packages read the same
factors.
"""
from __future__ import annotations

import dataclasses
import json
import os

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.chunks import BYTES, ChunkInfo, chunk_inventory
from repro_torch.core.hardware import HardwareSpec, MeshSpec
from repro_torch.core.plan import MemoryPlan
from repro_torch.core.profiler import BlockProfile, profile_superblock

ADAM_FLOPS_PER_PARAM = 12.0  # fused Adam: ~12 flops/param (exp avgs + update)
FP32 = 4

# Uncalibrated default wire-bytes multiplier for the gradient reduce under
# each compression mode, for the legacy in-jit ("xla") sync path. Kept for
# backward compatibility and as the fallback when no calibration JSON has
# been loaded — but note it encodes the *optimistic fiction* that in-jit
# compression halves wire bytes; measurement says it does not (the reduce XLA
# inserts moves the raw grads). Prefer wire_factor(), which consults the
# calibration produced by benchmarks/calibrate_wire.py.
GRAD_WIRE_FACTOR = {"none": 1.0, "bf16": 1.0, "int8_ef": 0.5}

# Analytic defaults per (sync_mode, grad_compress), used until a calibration
# JSON overrides them. The xla column is 1.0 across the board — GSPMD reduces
# the raw gradients before the compression numerics run, a structural fact
# independent of backend — so a missing calibration file never re-introduces
# the 0.5 fiction into the search. "manual" factors are payload-size ratios
# vs the bf16 grads the uncompressed reduce moves; the topology cost of each
# manual pipeline is modeled separately in t_reduce. "int8_ef_rs" is the
# reduce-scatter pipeline for ZeRO-sharded chunks (manual_sync_kind zero2/
# zero3): same int8 payload ratio, but an all_to_all that moves (z-1)/z of
# the compressed bytes instead of the gather's (z-1) — calibrated from the
# s8 collective bytes in the compiled HLO (benchmarks/calibrate_wire.py).
# "gather_bf16" scales the *param* all-gathers of the manual ZeRO pipelines
# (lazy per-chunk gathers + BWD re-gathers, priced by t_gather) — fitted
# from the bf16 all-gather bytes of a zero3 program vs the modeled
# (z-1)/z-per-chunk topology bytes.
DEFAULT_WIRE_FACTORS = {
    # "act_compress" scales the quantize/dequantize HBM streams of the
    # compressed activation policies (compress8/compress16, priced by
    # Workload.t_act_compress_pass) against the analytic read-full +
    # write-compressed byte count — calibrated from the pallas_call block
    # census of the fused quantize kernel at activation shapes
    # (benchmarks/calibrate_wire.py's act_compress config). Present under
    # both sync modes: the policy seam is sync-agnostic.
    "xla": {"none": 1.0, "bf16": 1.0, "int8_ef": 1.0, "act_compress": 1.0},
    # "fused_quant" scales the *HBM pass* count of the fused int8
    # quantize+pack kernel (kernels/fused_quant.py) against the analytic
    # one-pass model — calibrated from the pallas_call block-spec bytes of
    # the jitted kernel (benchmarks/calibrate_wire.py's kernel configs).
    "manual": {"none": 1.0, "bf16": 1.0, "int8_ef": 0.5, "int8_ef_rs": 0.5,
               "gather_bf16": 1.0, "fused_quant": 1.0, "act_compress": 1.0},
    # Serving pipelines (repro_torch.serve). "h2d_page" scales the cold-page
    # fetch bytes of the paged decode step against the modeled
    # pages x page_bytes x attention-layers product — calibrated from the
    # page-fetch slices of the compiled paged program
    # (benchmarks/calibrate_wire.py's h2d_page config). "paged_attn" scales
    # the fused decode-attention kernel's per-layer cache stream (hot ring +
    # cold tiles, KERNEL_CACHE_PASSES analytic passes) the same way. Per-key
    # defaulting (schema v2) keeps pre-serving calibration files loading
    # cleanly.
    "serve": {"h2d_page": 1.0, "paged_attn": 1.0},
}

# fp32 error-feedback residual per param = 2x the bf16 grad bytes; the
# calibration JSON can override with the measured state-size delta.
DEFAULT_EF_RESIDUAL_FACTOR = 2.0

# Fraction of a block's forward a compressed-activation block replays in BWD.
# Full remat replays everything between scan boundaries (1.0); the compress
# policies save each layer's quantized site outputs (norm1/mixer/mlp — see
# models/model.apply_position), so the replay only recomputes the segments
# *between* saved sites: roughly half the forward's matmul work (the mixer
# and mlp matmuls re-run from dequantized inputs; their saved outputs are
# not re-derived from scratch). This is what makes compress strictly cheaper
# than uniform remat in the searched lattice — it buys memory with bytes
# (quantize/dequant streams) instead of FLOPs.
ACT_COMPRESS_RECOMPUTE = 0.5

# Calibration JSON schema version this build writes/understands. The loader
# is forward-compatible by construction: any factor key absent from a loaded
# file (older schema, partial backend entry) falls back to the analytic
# default above — wire_factor()/ef_residual_factor() never KeyError on old
# calibrations, they just price the missing pipeline analytically.
CALIBRATION_SCHEMA_VERSION = 2

_CALIBRATION: dict | None = None
_CALIBRATION_LOADED = False


def load_wire_calibration(path: str | None = None) -> dict | None:
    """Load (and activate) a wire-cost calibration JSON.

    Schema (written by benchmarks/calibrate_wire.py; versioned since v2):
      {"version": 2, "backends": {"<backend>": {"wire_factors": {"xla":
      {...}, "manual": {...}}, "ef_residual_factor": float, ...}}}
    Files without a "version" key are treated as v1 (pre-gather-factor) and
    load fine — every factor key a loaded entry lacks falls back to the
    analytic DEFAULT_WIRE_FACTORS/DEFAULT_EF_RESIDUAL_FACTOR value at lookup
    time, so an old-format JSON never KeyErrors the search.
    With ``path=None`` resolves ``$REPRO_WIRE_CALIBRATION``, then the packaged
    ``src/repro_torch/core/wire_calibration.json``. Returns the active
    per-backend entry (``"cuda"`` when torch sees a card, else ``"cpu"``,
    falling back to the first entry) or None when no file exists.
    """
    global _CALIBRATION, _CALIBRATION_LOADED
    _CALIBRATION_LOADED = True
    if path is None:
        path = os.environ.get("REPRO_WIRE_CALIBRATION") or os.path.join(
            os.path.dirname(__file__), "wire_calibration.json")
    if not os.path.exists(path):
        _CALIBRATION = None
        return None
    with open(path) as f:
        data = json.load(f)
    backends = data.get("backends", {})
    import torch

    backend = "cuda" if torch.cuda.is_available() else "cpu"
    entry = backends.get(backend) or (next(iter(backends.values())) if backends else None)
    _CALIBRATION = entry
    return entry


def reset_wire_calibration() -> None:
    """Drop any loaded calibration (tests); next wire_factor() reloads."""
    global _CALIBRATION, _CALIBRATION_LOADED
    _CALIBRATION = None
    _CALIBRATION_LOADED = False


def _calibration() -> dict | None:
    if not _CALIBRATION_LOADED:
        load_wire_calibration()
    return _CALIBRATION


def wire_factor(sync_mode: str, compress: str) -> float:
    """Wire-bytes multiplier for the gradient reduce: calibrated when a
    calibration JSON is present, analytic default otherwise. ``compress``
    accepts the pipeline-qualified key ``"int8_ef_rs"`` (manual
    reduce-scatter for ZeRO-sharded chunks) in addition to the plain
    grad_compress values; calibrations predating the key fall back to the
    analytic default for it."""
    cal = _calibration()
    if cal is not None:
        try:
            return float(cal["wire_factors"][sync_mode][compress])
        except KeyError:
            pass
    return DEFAULT_WIRE_FACTORS[sync_mode][compress]


def ef_residual_factor() -> float:
    """EF residual bytes per grad byte (fp32 residual / bf16 grad = 2.0),
    calibrated against the measured train-state size delta when available."""
    cal = _calibration()
    if cal is not None and "ef_residual_factor" in cal:
        return float(cal["ef_residual_factor"])
    return DEFAULT_EF_RESIDUAL_FACTOR


@dataclasses.dataclass(frozen=True)
class Workload:
    """Everything the cost models need, profiled once per (cfg, shape, mesh)."""

    cfg: ModelConfig
    shape: ShapeConfig
    mesh: MeshSpec
    hw: HardwareSpec
    chunks: list[ChunkInfo]
    block: BlockProfile  # one superblock, batch=1, full (unsharded) dims
    positions: int = 1  # layers per superblock (remat granularity)
    max_position_param_bytes: int = 0  # largest single layer's params (gather unit)

    @property
    def n_blocks(self) -> int:
        return sum(1 for c in self.chunks if c.is_block)

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @property
    def seqs_per_device(self) -> float:
        return self.shape.global_batch / self.mesh.zero_degree

    def seqs_per_ubatch(self, plan: MemoryPlan) -> float:
        return self.seqs_per_device / plan.microbatch

    # ---- per-chunk compute (per microbatch, per device) -------------------
    def t_tp_allreduce(self, plan: MemoryPlan, n_ars: int = 2) -> float:
        """Megatron-style TP activation all-reduces on the critical path:
        ~2 per layer forward (attention out + MLP out), each moving the
        (B_ubatch, S, D) activation over the model axis."""
        t = self.mesh.tp_degree
        if t <= 1:
            return 0.0
        act = self.block.boundary_bytes * self.seqs_per_ubatch(plan)
        wire = 2.0 * (t - 1) / t * act
        bw = self.hw.ici_bw * self.hw.coll_efficiency
        return n_ars * self.positions * wire / bw

    def t_comp_fwd(self, chunk: ChunkInfo, plan: MemoryPlan) -> float:
        if not chunk.is_block:
            return self._t_embed_head(chunk, plan)
        scale = self.seqs_per_ubatch(plan) / self.mesh.tp_degree
        t_flops = self.hw.matmul_time(self.block.flops_fwd * scale)
        t_mem = self.hw.hbm_time(self.block.hbm_bytes_fwd * scale)
        return max(t_flops, t_mem) + self.t_tp_allreduce(plan)

    def t_comp_bwd(self, chunk: ChunkInfo, plan: MemoryPlan) -> float:
        return 2.0 * self.t_comp_fwd(chunk, plan)

    def _t_embed_head(self, chunk: ChunkInfo, plan: MemoryPlan) -> float:
        # head matmul: 2*B*S*D*V (embed lookup is bandwidth-only)
        cfg = self.cfg
        tokens = self.seqs_per_ubatch(plan) * self.shape.seq_len
        flops = 2.0 * tokens * cfg.d_model * cfg.vocab_size / self.mesh.tp_degree
        if chunk.name == "embed":
            return self.hw.hbm_time(chunk.param_bytes / self.mesh.tp_degree)
        return max(self.hw.matmul_time(flops), self.hw.hbm_time(chunk.param_bytes))

    # ---- per-chunk communication ------------------------------------------
    def t_gather(self, chunk: ChunkInfo, plan: MemoryPlan | None = None) -> float:
        """All-gather of a ZeRO-sharded chunk's params (Eq. 4 gather term).

        Under ``sync_mode="manual"`` the gathers are explicit bf16
        collectives (the zero3 lazy per-chunk gathers and the zero2 up-front
        gather), scaled by the calibrated ``gather_bf16`` factor — the
        measured bf16 all-gather bytes of a compiled zero3 program over this
        topology term (benchmarks/calibrate_wire.py)."""
        z = self.mesh.zero_degree
        nbytes = chunk.param_bytes / self.mesh.tp_degree
        if plan is not None and plan.sync_mode == "manual":
            nbytes *= wire_factor("manual", "gather_bf16")
        return nbytes * (z - 1) / z / self.mesh.gather_bw(self.hw)

    def t_upload(self, chunk: ChunkInfo, host_bw_eff: float) -> float:
        """Host->device shard upload for host-resident chunks (Eq. 4 upload)."""
        shard = chunk.param_bytes / (self.mesh.tp_degree * self.mesh.zero_degree)
        return shard / host_bw_eff

    def t_reduce(self, chunk: ChunkInfo, plan: MemoryPlan) -> float:
        """Gradient reduce (Eq. 6): all-reduce for persistent (replicated)
        chunks, reduce-scatter for sharded ones. The wire-bytes multiplier is
        the *calibrated* factor for (sync_mode, grad_compress) — see
        wire_factor() and docs/cost_model.md.

        sync_mode="manual" + int8_ef has two topologies, per chunk placement
        (dist/collectives.py):

          * persistent (replicated) chunk — gather-based all-reduce of the
            compressed payload (manual_int8_ef_sync): each chip receives
            (z-1) full payloads, vs the ring all-reduce's 2(z-1)/z passes —
            cheaper only while the compression ratio beats z/2;
          * ZeRO-sharded chunk — compressed reduce-scatter
            (manual_int8_ef_reduce_scatter): an all_to_all moving (z-1)/z of
            the int8 bytes, i.e. the scatter topology at the compressed
            payload size ("int8_ef_rs" factor) — roughly half the xla
            reduce-scatter's bf16 bytes, and 1/z of the gather pipeline's.

        Manual bf16/none use psum/psum_scatter (ring) like the xla path.
        """
        z = self.mesh.zero_degree
        bw = self.mesh.gather_bw(self.hw)
        sharded = (plan.chunk_placement(chunk.index) != "persist"
                   or plan.zero1_persistent)
        if plan.sync_mode == "manual" and plan.grad_compress == "int8_ef":
            if sharded:
                factor = wire_factor("manual", "int8_ef_rs")
                nbytes = chunk.grad_bytes * factor / self.mesh.tp_degree
                return (nbytes * (z - 1) / z / bw
                        + self._t_quantize_pass(chunk, fused_aware=True))
            factor = wire_factor("manual", "int8_ef")
            nbytes = chunk.grad_bytes * factor / self.mesh.tp_degree
            return (nbytes * (z - 1) / bw
                    + self._t_quantize_pass(chunk, fused_aware=False))
        factor = wire_factor(plan.sync_mode, plan.grad_compress)
        nbytes = chunk.grad_bytes * factor / self.mesh.tp_degree
        if not sharded:
            return 2.0 * nbytes * (z - 1) / z / bw
        return nbytes * (z - 1) / z / bw

    def _t_quantize_pass(self, chunk: ChunkInfo, *, fused_aware: bool) -> float:
        """HBM time of the int8 quantize+pack stage feeding the compressed
        reduce. The fp32 chunk working set (2x the bf16 grad bytes) is
        crossed once by the fused quantizer (``kernels.fused_quantize_ef``:
        absmax + quantize + EF residual in one pass) vs three times by the
        unfused absmax/round/residual sequence, scaled by the calibrated
        "fused_quant" factor. Only the reduce-scatter pipeline dispatches to
        the fused quantizer; the persistent gather variant stays unfused
        (``fused_aware=False``). The port always takes the fused one: its
        CUDA kernel on the card, its one-call plain version on the CPU (the
        reference's ``fused_quant_enabled()`` with Pallas active).
        """
        passes = 1.0 if fused_aware else 3.0
        passes *= wire_factor("manual", "fused_quant")
        work = chunk.grad_bytes * 2.0 / self.mesh.tp_degree
        return self.hw.hbm_time(passes * work)

    def t_grad_offload(self, chunk: ChunkInfo, host_bw_eff: float) -> float:
        shard = chunk.grad_bytes / (self.mesh.tp_degree * self.mesh.zero_degree)
        return shard / host_bw_eff

    # ---- activation swap traffic -------------------------------------------
    def boundary_dev_bytes(self, plan: MemoryPlan) -> float:
        """Per-device bytes of one block-boundary activation (the scan carry).

        With sequence-parallel activation sharding the boundary is split over
        the TP axis as well as batch."""
        scale = self.seqs_per_ubatch(plan)
        b = self.block.boundary_bytes * scale
        return b / self.mesh.tp_degree if plan.seq_shard_acts else b

    def swap_bytes_per_block(self, plan: MemoryPlan) -> float:
        """Bytes offloaded to host per swap block per microbatch, per device.

        Swap offloads the block-*interior* residuals; the boundary (scan
        carry) stays on device (see plan.py)."""
        scale = self.seqs_per_ubatch(plan)
        return self.block.act_residual_bytes * scale / self.mesh.tp_degree

    def saved_bytes_per_block(self, plan: MemoryPlan, policy: str) -> float:
        """Device-resident activation bytes a block leaves behind in FWD.

        Remat is applied per *position* (layer) by default, so a checkpointed
        superblock saves one boundary per position; grouped checkpointing
        (ckpt_group=g) saves 1/g of them."""
        boundary = self.positions * self.boundary_dev_bytes(plan)
        if policy == "checkpoint":
            return boundary / max(plan.ckpt_group, 1)
        if policy == "swap":
            return boundary
        if policy in ("compress8", "compress16"):
            # the scan carries stay full precision; the per-layer site
            # tensors persist as the quantized payload
            return boundary + self.compressed_act_bytes(plan, policy)
        scale = self.seqs_per_ubatch(plan)
        inner = self.block.act_residual_bytes * scale / self.mesh.tp_degree
        return boundary + inner

    # ---- compressed activation policy (compress8 / compress16) -----------
    def act_sites_per_position(self) -> float:
        """Save sites one layer tags through the quantize-on-save seam
        (models/model.apply_position): norm1 output, mixer output, mlp/moe
        output — plus the cross-attention site on encoder-decoder stacks.
        Each site is one (B, S, D) boundary-shaped tensor."""
        return 4.0 if self.cfg.kind == "encdec" else 3.0

    def act_site_bytes_per_block(self, plan: MemoryPlan) -> float:
        """Full-precision bytes of one block's save-site tensors."""
        return (self.positions * self.act_sites_per_position()
                * self.boundary_dev_bytes(plan))

    def compressed_act_bytes(self, plan: MemoryPlan, policy: str) -> float:
        """One block's quantized payload resident FWD->BWD: int8 + per-row
        scales for compress8 (~1 B/elem), bf16 downcast for compress16."""
        itemsize = BYTES[self.cfg.dtype]
        ratio = (1.0 if policy == "compress8" else 2.0) / itemsize
        return self.act_site_bytes_per_block(plan) * ratio

    def t_act_compress_pass(self, plan: MemoryPlan, policy: str) -> float:
        """HBM time of one quantize (FWD save) or dequantize (BWD use)
        stream over one block's sites: read full + write compressed (or the
        reverse), scaled by the calibrated act_compress factor."""
        nbytes = (self.act_site_bytes_per_block(plan)
                  + self.compressed_act_bytes(plan, policy))
        return self.hw.hbm_time(
            nbytes * wire_factor(plan.sync_mode, "act_compress"))

    def recompute_workspace(self, plan: MemoryPlan) -> float:
        """Peak residuals live while one rematted region is re-run in BWD:
        one position for per-layer remat, g superblocks for grouped remat."""
        scale = self.seqs_per_ubatch(plan)
        resid_sb = self.block.act_residual_bytes * scale / self.mesh.tp_degree
        if plan.ckpt_group > 1:
            return plan.ckpt_group * resid_sb + self.boundary_dev_bytes(plan)
        return resid_sb / self.positions + self.boundary_dev_bytes(plan)


def build_workload(
    cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec, hw: HardwareSpec
) -> Workload:
    import math

    from repro_torch.core.chunks import _defs_leaves
    from repro_torch.models.model import param_defs, superblock_period

    # largest single position's parameter bytes (the point-of-use gather unit)
    defs = param_defs(cfg)["blocks"]
    r = max((d.shape[0] for d in _defs_leaves(defs)), default=1)
    max_pos = 0
    for pos, sub in defs.items():
        nbytes = sum(
            math.prod(d.shape) * (2 if d.dtype == "bfloat16" else 4)
            for d in _defs_leaves(sub)
        ) // r
        max_pos = max(max_pos, nbytes)

    return Workload(
        cfg=cfg,
        shape=shape,
        mesh=mesh,
        hw=hw,
        chunks=chunk_inventory(cfg),
        block=profile_superblock(cfg, 1, shape.seq_len),
        positions=superblock_period(cfg),
        max_position_param_bytes=max_pos,
    )


def step_totals(w: Workload, plan: MemoryPlan) -> tuple[float, float]:
    """(flops, hbm_bytes) per chip per training step — the trip-count-aware
    analytic oracle the roofline consumes (XLA CPU cost_analysis undercounts
    loop bodies)."""
    mesh = w.mesh
    scale = w.seqs_per_ubatch(plan)
    mb = plan.microbatch
    blocks = [c for c in w.chunks if c.is_block]
    f_fwd = w.block.flops_fwd * scale / mesh.tp_degree
    b_fwd = w.block.hbm_bytes_fwd * scale / mesh.tp_degree
    flops = bytes_ = 0.0
    for c in blocks:
        pol = plan.block_policy(c.block_index)
        recompute = 0.0
        if w.shape.is_training:
            if pol in ("checkpoint", "swap"):
                recompute = 1.0
            elif pol in ("compress8", "compress16"):
                recompute = ACT_COMPRESS_RECOMPUTE
        mult = (3.0 + recompute) if w.shape.is_training else 1.0
        flops += f_fwd * mult * mb
        bytes_ += b_fwd * mult * mb
        if pol in ("compress8", "compress16") and w.shape.is_training:
            # quantize-on-save (FWD) + dequantize-on-use (BWD) streams
            bytes_ += 2.0 * (w.act_site_bytes_per_block(plan)
                             + w.compressed_act_bytes(plan, pol)) * mb
    # head matmul + embed traffic
    tokens_dev = scale * w.shape.seq_len * mb
    head_flops = 2.0 * tokens_dev * w.cfg.d_model * w.cfg.vocab_size / mesh.tp_degree
    flops += head_flops * (3.0 if w.shape.is_training else 1.0)
    emb = w.chunks[0].param_bytes / mesh.tp_degree
    bytes_ += emb
    if w.shape.is_training:
        # optimizer traffic: read+write states (16 B/param resident view)
        for c in w.chunks:
            place = plan.chunk_placement(c.index)
            opt = (c.optim_bytes + c.param_bytes + c.grad_bytes) / mesh.tp_degree
            if place == "persist" and not plan.zero1_persistent:
                bytes_ += 2 * opt
            elif place != "host":
                bytes_ += 2 * opt / mesh.zero_degree
            flops += ADAM_FLOPS_PER_PARAM * c.param_count / mesh.n_chips
    return flops, bytes_


# ---------------------------------------------------------------------------
# Serving: paged KV-cache fetch terms (repro_torch.serve)
# ---------------------------------------------------------------------------
def _attn_layer_count(cfg: ModelConfig) -> int:
    return sum(1 for layer in range(cfg.num_layers)
               if cfg.mixer_at(layer) == "attention")


def page_fetch_bytes_per_step(cfg: ModelConfig, shape: ShapeConfig,
                              mesh: MeshSpec, spec) -> float:
    """Per-device host-link bytes one paged decode step moves, worst case:
    every attention layer fetches its ``n_cold`` cold pages (k and v) while
    the hot window serves the rest from HBM. The write-through token update
    is negligible against the page reads and is not priced."""
    hd = cfg.resolved_head_dim
    itemsize = BYTES[cfg.dtype]
    page_global = 2 * shape.global_batch * spec.page_size * cfg.num_kv_heads * hd * itemsize
    per_dev = page_global / (mesh.zero_degree * mesh.tp_degree)
    return spec.n_cold * per_dev * _attn_layer_count(cfg)


def t_page_fetch(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec,
                 hw: HardwareSpec, spec) -> float:
    """Host-link time of one paged decode step's cold-page fetches, at the
    calibrated ``h2d_page`` factor (wire_factor("serve", "h2d_page"))."""
    nbytes = page_fetch_bytes_per_step(cfg, shape, mesh, spec)
    return nbytes * wire_factor("serve", "h2d_page") / hw.host_bw


# HBM passes over each attention layer's cache working set in one paged
# decode step. The plain rebuild (the CPU path, ``ref.paged_attention_ref``)
# reads the hot/cold sources, writes the gathered transient reconstruction,
# then re-reads it for attention: 3 passes. The CUDA kernel
# (``kernels/csrc/paged_attention.cu``) streams hot-ring rows and cold rows
# straight into the attention splits -- read K, read V, no transient
# materialization: 2 passes, scaled by the calibrated
# wire_factor("serve", "paged_attn").
LAX_REBUILD_CACHE_PASSES = 3.0
KERNEL_CACHE_PASSES = 2.0


def decode_kernel_active() -> bool:
    """Does the decode step route through the paged-attention kernel?

    In the port it does exactly when the engine's device is CUDA (the
    kernels package routes by the tensor's device, with no other switch):
    an engine passes ``kernel=`` for its own device; without it, the device
    an engine takes by default, CUDA when torch sees a card."""
    import torch

    return torch.cuda.is_available()


def paged_cache_read_bytes(cfg: ModelConfig, shape: ShapeConfig,
                           mesh: MeshSpec, spec,
                           kernel: bool | None = None) -> float:
    """Per-device HBM bytes one paged decode step reads from the KV cache:
    the resident hot rings plus each attention layer's per-step cache
    stream at the kernel-aware pass count (see LAX_REBUILD_CACHE_PASSES /
    KERNEL_CACHE_PASSES)."""
    from repro_torch.core.serve_plan import _paged_parts_per_device

    if kernel is None:
        kernel = decode_kernel_active()
    parts = _paged_parts_per_device(cfg, shape, mesh, spec)
    if kernel:
        passes = KERNEL_CACHE_PASSES * wire_factor("serve", "paged_attn")
    else:
        passes = LAX_REBUILD_CACHE_PASSES
    return parts["hbm"] + passes * parts["transient"] * _attn_layer_count(cfg)


def t_decode_compute(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec,
                     hw: HardwareSpec, spec=None,
                     kernel: bool | None = None) -> float:
    """One decode step's compute window per device: the active-parameter
    matmuls against the weight + cache read bandwidth floor.

    With a paging ``spec`` the cache term is priced kernel-aware
    (``paged_cache_read_bytes``): the fused paged-attention kernel streams
    2 passes over each layer's cache working set where the lax rebuild
    takes 3, so the modeled decode window shrinks when the kernel is
    active. ``kernel=None`` auto-resolves via ``decode_kernel_active()``;
    without a spec the resident-cache pricing is unchanged."""
    b_loc = shape.global_batch / mesh.zero_degree
    flops = 2.0 * cfg.active_param_count() * b_loc / mesh.tp_degree
    weights_dev = sum(c.param_bytes for c in chunk_inventory(cfg)) / mesh.tp_degree
    from repro_torch.core.serve_plan import cache_bytes_per_device

    if spec is None:
        read = weights_dev + cache_bytes_per_device(cfg, shape, mesh)
    else:
        read = weights_dev + paged_cache_read_bytes(cfg, shape, mesh, spec,
                                                    kernel=kernel)
    return max(hw.matmul_time(flops), hw.hbm_time(read))


# A prefill chunk interleaved into the decode loop stalls in-flight streams
# for its whole runtime: budget it at this many decode-step windows so the
# added inter-token latency stays bounded (the scheduler enforces at most
# one consecutive prefill tick on top — serve/scheduler.py:should_prefill).
PREFILL_STALL_BUDGET_STEPS = 8


def t_prefill_chunk(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec,
                    hw: HardwareSpec, chunk: int, spec=None,
                    kernel: bool | None = None) -> float:
    """Runtime of one chunked-prefill call ingesting ``chunk`` tokens/slot.

    The chunk program is a scan of ``chunk`` single-token decode steps
    (serve/prefill.py), so its cost is the decode-step window — compute vs.
    cold-page fetch, whichever dominates on a paged plan — times the chunk
    length. Priced next to ``t_page_fetch`` so the planner reasons about
    admission latency and fetch drain with one vocabulary. ``kernel`` as in
    ``t_decode_compute``."""
    per_tok = t_decode_compute(cfg, shape, mesh, hw, spec=spec, kernel=kernel)
    if spec is not None:
        per_tok = max(per_tok, t_page_fetch(cfg, shape, mesh, hw, spec))
    return chunk * per_tok


def choose_prefill_chunk(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec,
                         hw: HardwareSpec, spec=None,
                         max_chunk: int | None = None,
                         kernel: bool | None = None) -> int:
    """Largest prefill chunk whose runtime fits the decode-latency budget
    (``PREFILL_STALL_BUDGET_STEPS`` decode windows), clamped to
    [1, max_chunk]. Bigger chunks amortize per-call dispatch but each call
    stalls in-flight decode streams for ``t_prefill_chunk``; the budget caps
    that stall at a bounded number of inter-token latencies. ``kernel`` as
    in ``t_decode_compute``: an engine passes whether its device is CUDA."""
    per_tok = t_decode_compute(cfg, shape, mesh, hw, spec=spec, kernel=kernel)
    if spec is not None:
        per_tok = max(per_tok, t_page_fetch(cfg, shape, mesh, hw, spec))
    budget = PREFILL_STALL_BUDGET_STEPS * t_decode_compute(cfg, shape, mesh, hw,
                                                           spec=spec, kernel=kernel)
    chunk = max(1, int(budget / per_tok)) if per_tok > 0 else (max_chunk or 1)
    if max_chunk is not None:
        chunk = min(chunk, max_chunk)
    return chunk


def page_fetch_feasible(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec,
                        hw: HardwareSpec, spec) -> bool:
    """Can the double-buffered prefetch hide the cold-page fetches?

    Mirrors the training path's ``swap_feasible`` drain check: the paged
    decode step overlaps h2d fetches with attention compute, so the pipeline
    sustains decode speed iff one step's fetch bytes drain within one step's
    compute window. Infeasible specs still *run* — they just decode at
    host-link speed — so the planner prefers feasible hot windows but may
    fall back (serve_plan)."""
    return t_page_fetch(cfg, shape, mesh, hw, spec) <= t_decode_compute(
        cfg, shape, mesh, hw, spec=spec)


def serve_totals(w: Workload, plan: MemoryPlan) -> tuple[float, float]:
    """(flops, hbm_bytes) per chip for one serve step (prefill or decode)."""
    mesh = w.mesh
    if w.shape.mode == "prefill":
        return step_totals(w, plan)
    # decode: one token, full weight + cache read
    b_loc = w.shape.global_batch / mesh.zero_degree
    n_active = w.cfg.active_param_count()
    flops = 2.0 * n_active * b_loc / mesh.tp_degree
    weights_dev = sum(c.param_bytes for c in w.chunks) / mesh.tp_degree
    if plan.n_persist < plan.n_chunks:
        weights_dev = weights_dev  # gathered through HBM once either way
    from repro_torch.core.serve_plan import cache_bytes_per_device, paging_from_plan

    spec = paging_from_plan(w.cfg, w.shape, plan)
    if spec is None:
        cache_dev = cache_bytes_per_device(w.cfg, w.shape, mesh)
    else:
        # paged decode: HBM sees the hot rings plus each layer's per-step
        # cache stream at the kernel-aware pass count (the cold pages ride
        # the host link, priced separately by t_page_fetch)
        cache_dev = paged_cache_read_bytes(w.cfg, w.shape, mesh, spec)
    return flops, weights_dev + cache_dev


# ---------------------------------------------------------------------------
# Runtime model (Eq. 2-7)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RuntimeBreakdown:
    t_fwd: float
    t_bwd: float
    t_gpu_optim: float
    t_cpu_optim: float
    t_iteration: float
    tokens_per_second: float
    swap_feasible: bool

    def row(self) -> dict:
        return {k: round(v, 4) if isinstance(v, float) else v for k, v in vars(self).items()}


def _host_bw_contention(w: Workload, plan: MemoryPlan) -> tuple[float, bool]:
    """Effective host-link bandwidth left for parameter traffic when
    activation swapping shares the link (paper §3.3's contention modeling).

    Returns (effective host bw, swap feasible within compute window)."""
    hw = w.hw
    if plan.n_swap == 0:
        return hw.host_bw, True
    blocks = [c for c in w.chunks if c.is_block]
    t_fwd_compute = sum(w.t_comp_fwd(c, plan) for c in blocks)
    swap_total = plan.n_swap * w.swap_bytes_per_block(plan)
    swap_time = swap_total / hw.host_bw
    # swap must drain within the forward compute window (else it backs up
    # into the backward pass and stalls it — infeasible by construction)
    feasible = swap_time <= t_fwd_compute
    util = min(swap_time / max(t_fwd_compute, 1e-9), 1.0)
    return hw.host_bw * max(1.0 - util, 0.05), feasible


def estimate_runtime(w: Workload, plan: MemoryPlan) -> RuntimeBreakdown:
    host_bw_eff, feasible = _host_bw_contention(w, plan)
    n = w.n_chunks
    chunks = w.chunks
    manual_kind = (plan.manual_sync_kind(w.mesh.tp_degree)
                   if plan.sync_mode == "manual" else None)

    # --- comm/compute combine: overlap term (docs/cost_model.md §2) --------
    # The xla path always prices per-chunk comm as max(compute, comm) —
    # GSPMD's scheduler owns overlap there. Manual plans carry an explicit
    # knob: with ``plan.overlap`` (default) the deferred-accumulation
    # reduce-scatters, the prefetch-pipelined zero3 gathers, and the
    # barrier-ordered host fetches hide under compute, so each chunk prices
    # t_overlap = max(t_compute_chunk, t_comm_chunk); with ``overlap=False``
    # every manual comm term serializes (t_compute + t_comm) — that sum is
    # the pre-overlap schedule BENCH_train.json and the fidelity rows
    # compare against.
    serial_all = manual_kind is not None and not plan.overlap

    def combine(*terms: float) -> float:
        return sum(terms) if serial_all else max(terms)

    # --- forward (Eq. 3): pipeline of compute vs next-chunk prefetch -------
    t_fwd = 0.0
    for i in range(n + 1):
        t_comp = w.t_comp_fwd(chunks[i - 1], plan) if i >= 1 else 0.0
        if i >= 1 and chunks[i - 1].is_block:
            pol_f = plan.block_policy(chunks[i - 1].block_index)
            if pol_f in ("compress8", "compress16"):
                t_comp += w.t_act_compress_pass(plan, pol_f)  # quantize-on-save
        t_pref = 0.0
        if i < n:
            c = chunks[i]
            place = plan.chunk_placement(c.index)
            if place != "persist":
                t_pref = w.t_gather(c, plan)
                if place == "host" and plan.host_params:
                    t_pref += w.t_upload(c, host_bw_eff)
        t_fwd += combine(t_comp, t_pref)

    # --- backward (Eq. 5): compute+recompute vs re-gather vs reduce --------
    # BWD visits chunks in reverse execution order.
    order = list(range(n - 1, -1, -1))
    t_bwd = 0.0
    for idx, i in enumerate(order):
        c = chunks[i]
        t_comp = w.t_comp_bwd(c, plan)
        if c.is_block and plan.block_policy(c.block_index) == "checkpoint":
            t_comp += w.t_comp_fwd(c, plan)  # T_recomp
        if c.is_block and plan.block_policy(c.block_index) in ("compress8",
                                                              "compress16"):
            # partial replay of the segments between saved sites + the
            # dequantize-on-use stream
            pol_b = plan.block_policy(c.block_index)
            t_comp += (ACT_COMPRESS_RECOMPUTE * w.t_comp_fwd(c, plan)
                       + w.t_act_compress_pass(plan, pol_b))
        if c.is_block and plan.block_policy(c.block_index) == "swap":
            # activation fetch from host for this block (overlappable but
            # competes on the host link)
            t_fetch = w.swap_bytes_per_block(plan) / host_bw_eff
        else:
            t_fetch = 0.0
        # re-gather of the *next* chunk to be visited (Eq. 7): only when its
        # gathered weights were not buffered. Manual "zero2" gathers the whole
        # tree up front and keeps it live for the step, so it never re-gathers
        # regardless of n_buffer; "zero3" follows the xla path's buffering
        # semantics for block chunks (that is the point of the lazy-gather
        # refactor) while its non-block chunks (embed/head/encoder) are
        # gathered at point of use outside any remat region and survive to
        # BWD — no re-gather, like the xla path's fetch().
        t_pref = 0.0
        if idx + 1 < n:
            nxt = chunks[order[idx + 1]]
            buffered = (plan.chunk_buffered(nxt.index)
                        or manual_kind == "zero2"
                        or (manual_kind == "zero3" and not nxt.is_block))
            if plan.chunk_placement(nxt.index) != "persist" and not buffered:
                t_pref = w.t_gather(nxt, plan)
                if plan.chunk_placement(nxt.index) == "host" and plan.host_params:
                    t_pref += w.t_upload(nxt, host_bw_eff)
        # reduce+offload of the previous chunk's grads (Eq. 6)
        t_red = 0.0
        if idx >= 1:
            prv = chunks[order[idx - 1]]
            t_red = w.t_reduce(prv, plan)
            if plan.chunk_placement(prv.index) == "host" and plan.host_params:
                t_red += w.t_grad_offload(prv, host_bw_eff)
        t_bwd += combine(t_comp, t_pref, t_red, t_fetch)
    # tail: last visited chunk's reduce
    t_bwd += w.t_reduce(chunks[order[-1]], plan)

    # --- optimizer (Eq. 2) ---------------------------------------------------
    hw, mesh = w.hw, w.mesh
    t_gpu = t_cpu = 0.0
    for c in chunks:
        place = plan.chunk_placement(c.index)
        opt_traffic = (c.optim_bytes + c.param_bytes + c.grad_bytes) / mesh.tp_degree
        if place == "persist" and not plan.zero1_persistent:
            t_gpu += hw.hbm_time(2 * opt_traffic)  # read+write, replicated
        elif place == "host" and plan.host_optimizer:
            shard_params = c.param_count / (mesh.tp_degree * mesh.zero_degree)
            t_flops = ADAM_FLOPS_PER_PARAM * shard_params / hw.host_flops
            t_dma = 26.0 * shard_params / hw.host_bw  # m+v+master down + back (+p)
            t_cpu += max(t_flops, t_dma)
        else:
            t_gpu += hw.hbm_time(2 * opt_traffic / mesh.zero_degree)

    mb = plan.microbatch
    t_iter = mb * t_fwd + max(mb * t_bwd + t_gpu, t_cpu)
    tokens = w.shape.global_batch * w.shape.seq_len
    return RuntimeBreakdown(
        t_fwd=mb * t_fwd,
        t_bwd=mb * t_bwd,
        t_gpu_optim=t_gpu,
        t_cpu_optim=t_cpu,
        t_iteration=t_iter,
        tokens_per_second=tokens / t_iter,
        swap_feasible=feasible,
    )


# ---------------------------------------------------------------------------
# Memory model (Eq. 8-11): block-granular trajectory replay
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MemoryBreakdown:
    model_states: float
    gathered_buffers: float
    activations: float
    workspace: float
    logits: float
    peak: float
    trajectory: list[float]  # M_cur over fwd blocks then bwd blocks (Fig. 2)

    def row(self) -> dict:
        d = {k: round(v / 1e9, 3) for k, v in vars(self).items() if isinstance(v, float)}
        return d


def estimate_memory(w: Workload, plan: MemoryPlan, ce_chunk: int = 2048) -> MemoryBreakdown:
    mesh, cfg = w.mesh, w.cfg
    tp, z = mesh.tp_degree, mesh.zero_degree

    # --- resident model states (Eq. 11's M_persist / M_buffer terms) -------
    # int8_ef carries an fp32 error-feedback residual per param (calibrated
    # factor, default 2x the bf16 grad bytes), sharded/placed exactly like
    # the gradients it corrects.
    ef = ef_residual_factor() if plan.grad_compress == "int8_ef" else 0.0
    states = 0.0
    gathered = 0.0
    for c in w.chunks:
        place = plan.chunk_placement(c.index)
        full = (c.param_bytes + c.grad_bytes * (1 + ef) + c.optim_bytes) / tp
        if place == "persist":
            if plan.zero1_persistent:
                states += (c.param_bytes + c.grad_bytes * (1 + ef)) / tp + c.optim_bytes / (tp * z)
            else:
                states += full
        elif place == "hbm":
            states += full / z
        elif place == "host" and not plan.host_params:
            # ZeRO-Offload split (+ device-resident EF residual, if any)
            states += (c.param_bytes + c.grad_bytes * (1 + ef)) / (tp * z)
        elif place == "host":
            states += ef * c.grad_bytes / (tp * z)  # EF residual stays on device
        if plan.chunk_buffered(c.index) and place != "persist":
            gathered += c.param_bytes / tp
    # host chunks: grads live on device only in a 2-chunk reduce->offload window
    host_blocks = [c for c in w.chunks if plan.chunk_placement(c.index) == "host"]
    if host_blocks:
        states += 2 * max(c.grad_bytes for c in host_blocks) / (tp * z)
    manual_kind = (plan.manual_sync_kind(tp) if plan.sync_mode == "manual"
                   else None)
    if manual_kind == "zero2":
        # manual ZeRO-2 gathers every non-persistent chunk's bf16 params up
        # front and keeps them live for the whole step (full bf16 params,
        # shard-resident fp32 states/grads); buffered chunks were already
        # charged above. The "zero3" kind deliberately has NO such term —
        # its lazy per-chunk gathers live only inside the scan, so it pays
        # exactly the xla path's charges: buffered chunks (above) plus the
        # two in-flight gather units (below).
        gathered += sum(
            c.param_bytes for c in w.chunks
            if plan.chunk_placement(c.index) != "persist"
            and not plan.chunk_buffered(c.index)
        ) / tp
    elif manual_kind == "zero3":
        # zero3's non-block chunks (embed/head/encoder) are gathered at
        # point of use outside any remat region, so their gathered leaves
        # survive FWD->BWD regardless of n_buffer — charge them resident
        # (block chunks follow the xla-path buffering charges above)
        gathered += sum(
            c.param_bytes for c in w.chunks
            if not c.is_block
            and plan.chunk_placement(c.index) != "persist"
            and not plan.chunk_buffered(c.index)
        ) / tp
    # two in-flight gather buffers (prefetch + execute), the paper's n_buffer>=2
    # floor. The gather unit is one *position* (layer): hybrids/MoE gather a
    # 44B-param superblock layer-by-layer, not all at once.
    blocks = [c for c in w.chunks if c.is_block]
    if blocks and any(plan.chunk_placement(c.index) != "persist" for c in w.chunks):
        unit = w.max_position_param_bytes or max(c.param_bytes for c in blocks)
        gathered += 2 * unit / tp

    # --- activations (Eq. 8) -------------------------------------------------
    acts = 0.0
    traj = []
    for b in range(w.n_blocks):
        acts += w.saved_bytes_per_block(plan, plan.block_policy(b))
        traj.append(states + gathered + acts)

    # --- backward trajectory (Eq. 9-10 at block granularity) ---------------
    peak_bwd = 0.0
    cur = acts
    scale = w.seqs_per_ubatch(plan)
    recompute_ws = w.recompute_workspace(plan)
    grad_ws = w.boundary_dev_bytes(plan)  # dL/dx flowing between blocks
    transient = w.block.peak_transient_bytes * scale / tp / w.positions
    for b in range(w.n_blocks - 1, -1, -1):
        pol = plan.block_policy(b)
        # I_checkpoint term; the compress policies replay per-position
        # segments from the dequantized sites, so they carry the same
        # per-position replay workspace as checkpoint
        extra = (recompute_ws
                 if pol in ("checkpoint", "swap", "compress8", "compress16")
                 else 0.0)
        cur_peak = states + gathered + cur + extra + grad_ws + transient
        peak_bwd = max(peak_bwd, cur_peak)
        traj.append(cur_peak)
        cur -= w.saved_bytes_per_block(plan, pol)
        cur = max(cur, 0.0)

    # --- logits / loss workspace (chunked cross-entropy) --------------------
    toks = min(ce_chunk, w.shape.seq_len) * max(scale, 1.0)
    logits = toks * cfg.vocab_size / tp * (2 + FP32)  # bf16 logits + fp32 softmax
    if not w.shape.is_training:
        logits = max(scale, 1.0) * cfg.vocab_size / tp * (2 + FP32)

    workspace = w.block.peak_transient_bytes * scale / tp / w.positions
    if plan.sync_mode == "manual":
        # Per-kind sync workspace. Leaf size is approximated by the largest
        # single layer / non-block chunk (the embed table usually dominates).
        leaf = max([w.max_position_param_bytes]
                   + [c.param_bytes for c in w.chunks if not c.is_block])
        elems = leaf / BYTES[cfg.dtype]
        a2a = elems * 5.0 if plan.grad_compress == "int8_ef" else 0.0
        if manual_kind == "zero2":
            # post-AD reduce-scatter workspace, any wire format: one
            # microbatch's *full* local grad tree exists before the sync
            # collapses it to shard size (the sharded chunks' persistent
            # grads are only charged /z above). int8 additionally holds the
            # all_to_all buffers of the largest leaf — int8 chunk payload
            # (~1 B/elem) + the owner's fp32 dequantized shards (z shards of
            # N/z elems at 4 B) ~ 5 B/elem.
            grads_full = sum(
                c.grad_bytes for c in w.chunks
                if plan.chunk_placement(c.index) != "persist") / tp
            workspace = max(workspace, grads_full + a2a)
        elif manual_kind == "zero3":
            # the lazy-gather VJP reduce-scatters each leaf's cotangent the
            # moment AD produces it, so no full-grad-tree workspace exists —
            # only the largest chunk's full cotangent is transiently live
            # (plus the all_to_all buffers of its largest leaf).
            chunk_grad = max(
                (c.grad_bytes for c in w.chunks
                 if plan.chunk_placement(c.index) != "persist"),
                default=0) / tp
            workspace = max(workspace, chunk_grad + a2a)
        elif plan.grad_compress == "int8_ef":
            # gather-based sync: the largest gradient leaf is all-gathered as
            # int8 (z x N x 1B) and dequantized to fp32 (z x N x 4B) before
            # the mean collapses it — both live at once at the end of each
            # microbatch's backward.
            workspace = max(workspace, z * elems * 5.0)
    peak = max(max(traj) if traj else 0.0, states + gathered + workspace) + logits
    return MemoryBreakdown(
        model_states=states,
        gathered_buffers=gathered,
        activations=acts,
        workspace=workspace,
        logits=logits,
        peak=peak,
        trajectory=traj,
    )


# ---------------------------------------------------------------------------
# Overlap schedule simulator (tests/test_overlap.py property suite)
# ---------------------------------------------------------------------------
def zero3_prefetch_schedule(n_chunks: int, n_buffer: int, microbatch: int = 1,
                            prefetch_depth: int | None = None) -> dict:
    """Pure event-level replay of the manual zero3 gather schedule.

    Mirrors the lowered program (models/model.apply_runs prefetch path +
    step_builder's run layout, with n_persist = 0): buffered chunks are the
    last ``n_buffer``; inside the buffered run the pipeline prefetches chunk
    k+1's gather during chunk k's compute when ``prefetch_depth >= 2``;
    unbuffered chunks gather at point of use and free on exit; BWD visits in
    reverse, re-gathering unbuffered chunks transiently and consuming
    buffered ones. Each microbatch repeats the whole FWD+BWD (buffers never
    carry across microbatches).

    Returns ``{"max_live": ..., "max_inflight": ...}`` — the peak count of
    simultaneously live gathered chunk buffers, and the peak count of
    gathers issued but not yet consumed by compute. ``estimate_memory``
    charges ``n_buffer`` full buffered chunks plus two in-flight gather
    units for the same plan, so the schedule invariant the property test
    holds is ``max_live <= max(n_buffer, 1)`` (never more than the buffered
    set, one transient unit when nothing is buffered) and
    ``max_inflight <= prefetch_depth - 1``.
    """
    assert 0 <= n_buffer <= n_chunks and microbatch >= 1
    if prefetch_depth is None:
        prefetch_depth = 2 if n_buffer >= 2 else 1

    def buffered(i: int) -> bool:
        return i >= n_chunks - n_buffer

    max_live = max_inflight = 0
    for _ in range(microbatch):
        live: set[int] = set()
        inflight: set[int] = set()
        # forward
        for i in range(n_chunks):
            if i not in live:
                live.add(i)  # gather at point of use
            inflight.discard(i)  # compute consumes the prefetched gather
            if (prefetch_depth >= 2 and buffered(i) and i + 1 < n_chunks
                    and buffered(i + 1)):
                live.add(i + 1)
                inflight.add(i + 1)
            max_live = max(max_live, len(live))
            max_inflight = max(max_inflight, len(inflight))
            if not buffered(i):
                live.discard(i)  # freed on scan-carry exit
        # backward (reverse order); buffered buffers are consumed by their
        # own chunk's backward, unbuffered ones re-gather transiently
        for i in range(n_chunks - 1, -1, -1):
            if i not in live:
                live.add(i)
            max_live = max(max_live, len(live))
            live.discard(i)
        assert not live and not inflight
    return {"max_live": max_live, "max_inflight": max_inflight}
