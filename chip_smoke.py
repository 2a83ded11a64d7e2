#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one sm_90 card and nvcc:

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. the kernels' build from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a),
     with each kernel's registers, shared memory and spills from ptxas;
  3. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes, with its time, its plain version's, a library
     call's and the card's bound for the same work; the paged kernel also
     over a 65,536-row cache, with its split count (``n_split``) and, for a
     pinned cold store, a second yardstick that copies the rows the kernel
     reads over the host link, and no others, to the device before the
     library call (``library_with_copy_ms``);
  4. ``DecodeEngine`` at the full width and depth of ``mistral-7b`` (random
     bf16 weights from a seeded generator), serving 4 requests with chunked
     admission on a paged plan whose cold pages sit in pinned host memory,
     every decode tick and prefill step replayed from the engine's CUDA
     graph; both kernels must have been launched by that run. The same
     requests are then served once more by an engine on the same weights
     that launches every step from Python (``graphs=False``): its tokens and
     its launch counts must equal the graph engine's. One teacher-forced
     decode step through the kernels must agree with the plain path (same
     greedy token in every row). The engine's captured step is then timed
     twice: launched from Python (host wall time) and replayed from its
     graph (device time); one minus their ratio bounds from below the share
     of an eager step in which the card idles.

  5. the training kernels against their plain versions on the card, after
     the engine's weights are freed: FlashAttention forward (O and the
     log-sum-exp) and backward (dQ, dK, dV) at 32 query heads over 8 KV
     heads, hd 128, bf16, causal, at S 4096 (window 4096: the training
     shape), 8192 (the window masks) and 1000 (a ragged tile edge, forward
     only); fused Adam on one ``w1`` leaf (4096 x 14336) with its fp32
     states on the device and in pinned host memory. Each with its time,
     its plain version's, a library call's and the card's bound; the
     pinned case also with its segments and staging bytes (the wrapper's
     copy-engine pipeline) and a second yardstick that moves the same host
     bytes: master, m and v copied to the device, torch's fused Adam, the
     three copied back (``library_with_copy_ms``; ``library_copy_bytes``
     must equal ``host_bytes``);
  6. ``train_compare``: ``mistral-7b`` at full width and 2 layers, one
     training step from one cloned state through the kernels
     (``attn_impl="blockwise"``, ``use_fused_kernel=True``) and through the
     plain path (``"naive"``, ``False``): losses, gradient norms and every
     leaf's gradient must agree;
  7. ``train``: ``mistral-7b`` at full width and 8 layers, 4 steps through
     ``train_loop`` under a plan that checkpoints 4 layers, accumulates 2
     microbatches and keeps the optimizer states of block 7 and the head in
     pinned host memory; every loss finite, the first near ln 32000, each
     training kernel launched as often as the plan implies; it prints the
     median step time, tokens/s, peak device bytes, pinned host bytes and
     the model-FLOP share of the bf16 peak (``mfu``);
  8. ``train_policies``: the same model, seq 4096, global batch 2 in 2
     microbatches, through ``build_train_step`` and ``train_loop``: one run
     of 2 steps per uniform act policy (none, compress16, compress8,
     checkpoint, swap; all chunks on the device), whose device bytes left
     for the backward (``act_bytes``) must fall in that order; then 4 steps
     of a mixed plan with every policy, host-resident weights (one ``none``
     block fetched again for its backward, one block and the head
     buffered) and host optimizer states, whose kernel launches, weight
     bytes fetched, activation bytes swapped and quantizer calls must equal
     what the plan implies, then one profiled step (device time by kind,
     and the optimizer's span on the device with its time by kind); last,
     2 steps of that plan and 2 of the same
     act policies with every chunk on the device, from one init: losses
     and final fp32 masters must agree bitwise (the host weights' fetches,
     swaps and updates run on a side stream and through pinned memory,
     and change no value).

  9. ``plan``: ProTrain's planner on the card. ``local_cuda_hw()`` reads
     this card's memory, the host's memory and the host link's both-ways
     rate (read once, before the engine phase, which also prints what
     ``choose_prefill_chunk`` would pick for its engine). The port's
     profiler traces one full-width mistral-7b superblock (fake tensors:
     nothing is allocated) at seq 4096, the search runs for global batch 1
     at 32 layers (``search(compress="off", sync="xla")``, one card), and
     prints the plan, its modeled step and memory, the seconds it took, and
     the reference's profile and plan beside the port's. Then 1 warm-up and
     2 timed steps under that plan at 32 layers and full width through
     ``train_loop`` with a ``DriftMonitor``: losses finite, launches,
     fetched bytes and quantizer calls the plan's, pinned bytes the plan's
     host chunks', and the measured step, peak and pinned bytes beside the
     modeled ones; then one profiled step (device time by kind, the
     optimizer's span). If the host cannot pin what the plan puts there, the
     step runs at the deepest stack that fits and says so
     (``reduced_depth``); if the card runs out of memory, the capacity the
     search budgets against is lowered by the shortfall the card showed
     (doubled at each further attempt) and the search runs again
     (``oom_attempts``). Last, ``calibration``: the
     ``train`` and mixed plans priced on this card's spec beside their
     measured steps and peaks, with the full-depth run's row.

 10. ``moe_kernels``: the kernels at the MoE paths' shapes
     (``qwen2-moe-a2.7b``: 16 query over 16 KV heads, hd 128, no window,
     d 2048) against their plain versions, after the mistral phases'
     memory is freed: flash forward and backward at S 4096, paged attention
     ``main`` and ``long`` (pinned and device cold stores), RMSNorm at 4 and
     4096 rows of 2048, fused Adam on one pinned expert ``w1`` (60 x 2048 x
     1408); each line carries ``"path": "moe"``;
 11. ``moe_serve``: phase 4's engine and checks for ``qwen2-moe-a2.7b`` at
     full width and all 24 layers (28.6 GB of bf16 weights). Its
     teacher-forced step is held to ``MOE_ENGINE_TOL``, the greedy token
     must agree in every row whose plain top-1 leads its top-2 by more than
     that tolerance, and ``routing`` reports the share of (token, k)
     expert choices on which the kernel and plain paths agree;
 12. ``moe_plan``: phase 9 for ``qwen2-moe-a2.7b`` at ``MOE_PLAN_LAYERS``
     (4) of its 24 layers, a cut for the run's time: 229 GB of training
     state at 24 layers, more than card and host hold, so the depth is the
     deepest up to that whose searched plan's pinned states, as the caching host
     allocator takes them (``pinned_alloc_bytes``: each allocation rounded
     up to a power of two), fit the host (``depth_cuts``), after the
     allocator's cache from earlier phases is released
     (``moe_plan_host_cache``). Losses, the cross-entropy (``ces``) and the
     aux losses are printed apart; ``mfu`` counts the active parameters
     (``active_matmul_params``); the profiled step has the fp32 GEMMs of
     the dense dispatch and combine as their own kind (``gemm_fp32``).

 13. ``mamba_kernels``: the kernels at the Mamba-2 paths' shapes: RMSNorm
     at d 768 and 1536 (mamba2-130m's norm and gated norm) in 4 and 32,768
     rows, fused Adam on one fp32 leaf of 24 x 24 on the device, flash
     forward and backward and paged attention at the hybrid's 8 query
     heads over 1 KV head of 128; each line carries ``"path": "mamba"``;
 14. ``mamba_serve``: phase 4's engine and checks for ``mamba2-130m`` at
     full width and 6 of its 24 layers (``MAMBA_SERVE_LAYERS``), on the
     resident plan under replay
     admission (the default without attention); the teacher-forced plain
     path runs the plain RMSNorm too; ``mamba_state_bytes``;
 15. ``mamba_train_compare``: two steps of 2-layer full-width mamba2-130m
     at S 32,768, kernels against the plain path; ``mamba_ssd_fp32``: the
     SSD in fp32 on the card against the same code on the CPU (output,
     state and every gradient within ``SSD_TOL``); ``mamba_ssd_timing``:
     one block's SSD at the plan's shape, beside its chunk loop alone;
 16. ``mamba_plan``: phase 9 for ``mamba2-130m`` at 24 layers, S 32,768,
     beside the reference's profile; ``block_policies`` per block; the
     profiled step's ``ssd_chunk_loop_fwd_ms`` (device time inside the
     chunk loop's annotation); then ``mamba_calibration``;
 17. ``hybrid``: reduced Jamba at hd 128 and group 8 (``hybrid_config``):
     ``hybrid_serve`` (phase 4 on the paged plan, chunked admission) and
     ``hybrid_train`` (two steps, kernels against the plain path, at
     ``HYBRID_GRAD_COSINE``).

 18. ``encdec_kernels``: flash forward and backward at
     seamless-m4t-large-v2's heads (16 over 16 of 64, B 1): causal at S
     4096, non-causal at S 4096, non-causal 1024 query rows over 4096 key
     rows, each beside SDPA and its bound; paged ``main`` at hd 64, group
     1, cold store pinned and on the device; each line carries
     ``"path": "encdec"``;
 19. ``encdec_serve``: phase 4's engine and checks for
     seamless-m4t-large-v2's decoder at full width and ``ENCDEC_LAYERS``
     + ``ENCDEC_LAYERS`` (8 + 8) of its 24 + 24 layers, a cut for the
     run's time, prompts of 595 to 758 tokens; once the 4 requests hold their
     slots, each slot's cross cache is primed in place
     (``models/kvcache.prime_cross_cache``) from ``encode`` over seeded
     frames (4, 1024, 1024), on the graph and the eager engine alike;
     ``priming``: the captured step's logits over the primed cross cache
     differ from those over a zeroed one (the graph reads the primed
     bytes); no RMSNorm (LayerNorm model);
 20. ``encdec_train_compare``: two steps at full width, 2 encoder and 2
     decoder layers, S 4096 frames and tokens, kernels against the plain
     path (whole-row attention in the encoder, the decoder's self- and
     cross-attention; plain Adam), at train_compare's bounds, the flash
     launches the 2 + 2 layers imply; ``encdec_plan``: phase 9 for
     seamless-m4t-large-v2 at 8 + 8 layers, S 32,768 frames and tokens,
     B 1 (at S 16,384 if no searched plan trains, ``encdec_plan_failed``),
     with the time to draw a batch (its fp32 frames included; outside the
     timed steps) and where the front chunk (embedding and encoder) lies;
 21. ``vlm_kernels``: the kernels at llava-next-34b's shapes: flash
     forward and backward at 56 over 8 heads of 128 (group 7), causal S
     5,120 (1,024 patches and 4,096 tokens); paged ``main`` at group 7 and,
     in the same call, mistral-7b's group 4, cold store pinned and on the
     device; RMSNorm at 4 and 5,120 rows of 7,168; fused Adam on one w1
     (7168 x 20480), states on the device and pinned; the quantizer at
     5,120 x 7,168 bf16; each line carries ``"path": "vlm"``;
 22. ``vlm_serve``: phase 4's engine and checks for llava-next-34b at full
     width and ``VLM_SERVE_LAYERS`` (10) of its 60 layers (12.0 GB of bf16
     weights, ``vlm_init``; a cut for the run's time, from all 60),
     prompts of 595 to 758 tokens, one paged launch a layer a step; the
     engine serves tokens, as the JAX engine does;
 23. ``vlm_prefill``: ``build_prefill_step(chunk=None)`` on the served
     weights, B 4, 1,024 seeded patches ahead of 1,024 tokens: through the
     kernels against the plain path (whole-row attention, plain RMSNorm, a
     row at a time; ``greedy_check``), against zeroed patches (the logits
     must move), and without patches over each served prompt against the
     engine's first token; its device time and launches (a flash launch a
     layer, two RMSNorm launches a layer and one more);
 24. ``vlm_train_compare``: two steps at full width, 2 layers, S 4096
     tokens after 1,024 patches, kernels against the plain path, at
     train_compare's bounds; ``vlm_plan``: phase 9 for llava-next-34b at S
     4096 after 1,024 patches, B 1, at ``VLM_PLAN_LAYERS`` (8) layers or
     the deepest stack below whose pinned states fit the host
     (``depth_cuts``; a cut for the run's time: 13 layers fit the host);
     the block profile counts S
     positions, so a searched plan may run out of memory first
     (``oom_attempts``);
 25. ``dist_sync``: the gradient sync (``train/sync.py``) on mistral-7b at
     full width, 4 layers, B 2, S 4096, 3 timed steps a case from one
     init: the xla path with none, bf16 and int8 + EF through
     ``make_strategy`` on one rank, then ``ManualSync`` built directly at
     world one over a one-rank NCCL group for ddp, zero2 and zero3 (int8 +
     EF; zero3's last two layers buffered, gathered one layer ahead): each
     step's time, peak, ``ef_norm``, one profiled step (device time by kind,
     ``collective`` the NCCL kernels), the quantizer's launches (the plan's:
     one a sharded leaf a microbatch, none for ddp) and every manual kind's
     losses and fp32 masters against ``xla_int8_ef``'s (ddp and zero2
     bitwise, zero3 within ``DIST_ZERO3_RTOL`` and
     ``DIST_ZERO3_UPDATE_GAP``); then the quantizer
     against its plain version, bitwise, at the sync's chunks
     (``DIST_QUANT_CASES``: w1 / w3 / w2 and wq at z = 1, w1 at z = 4);
 26. ``dist_ranks``: one NCCL rank per visible card, each a process of its
     own (spawned), mistral-7b at 2 layers, one row a rank: the manual
     kinds, then ``dist_xla``'s two plans through the sharded ``XlaSync``
     (``dist_xla_ranks`` lines), 3 steps each; on one card a world of one,
     which it says;
 27. ``dist_xla``: the xla path on several ranks (``XlaSync`` sharded) on
     mistral-7b at full width, 4 layers, B 2, S 4096, the weights of
     ``dist_sync``: ``xla_host`` (host chunks, weights and states pinned,
     a swap block, checkpointed blocks, ``n_buffer`` 1, int8 + EF) and
     ``xla_zero`` (ZeRO-sharded chunks, two buffered, ``zero1_persistent``
     on the persistent ones), each 3 timed steps (and one profiled) through
     the sharded ``XlaSync`` built directly over a one-rank NCCL group, then
     3 through the single-device step: losses and fp32 masters bitwise
     (every collective of one rank is a copy); step time, peak, pinned
     bytes, launches, one profiled step (``collective``: NCCL's device
     time). Then the plan searched for mistral-7b at 32 layers, B 4, on 4
     data ranks, its modeled step and peak and what it would pin on one
     host, trained 3 steps where 4 cards are visible;
 28. ``tp``: the model axis (``dist/tensor_parallel.py``). The flash
     forward and backward at mistral-7b's shard shapes (model extent 2: 16
     over 4 heads of 128; 4: 8 over 2; S 4096, window 4096) and at the
     other families' at extent 2 (the hybrid's 4 over 1 of 128 at S 2048;
     seamless-m4t-large-v2's 8 over 8 of 64: causal and non-causal S 4096,
     1024 over 4096 rows; llava-next-34b's 28 over 4 of 128 at P + S =
     4,096) against their plain versions, each beside SDPA and its bound
     (``"path": "tp"``); then two processes on the one card, a gloo group
     (NCCL refuses two ranks on one device; gloo takes CUDA tensors in
     all-reduces, all-gathers and reduce-scatters: checked on an H100 with
     torch 2.11), each run 3 steps from the weights of seed 0, each loss
     and grad norm held to the single-device step from the same weights,
     which ran first (``TP_LOSS_TOL``, ``TP_NORM_RTOL``: a row-parallel
     product rounds its partial sums to bf16 and again after the
     reduction), each on the resident plan at full width and a depth cut
     for the run's time: ``tp_ranks``, data 1 x model 2, mistral-7b at
     ``TP_LAYERS`` (2) layers, B 1, S 4096, without and with
     ``seq_shard_acts``; ``tp_moe_data``, data 2 x model 1,
     qwen2-moe-a2.7b at 1 layer, B 2, S 4096, its capacity factor 1.25,
     the MoE
     routed over both ranks' tokens (with the share of choices the
     capacity dropped, counted on the one-device step); ``tp_families``,
     data 1 x model 2: mamba2-130m at 4 of 24 layers, B 1, S 8192, and
     llava-next-34b at 2 layers, 1,024 patches and 3,072 tokens, each
     without and with ``seq_shard_acts``; the reduced hybrid of ``hybrid``
     at S 2048; seamless-m4t-large-v2 at 2 + 2 layers, S 4096 frames and
     tokens; these take Adam steps of 3e-5
     (``TP_FAMILY_LR``: at mistral's 3e-4 bf16 rounding makes 3-step
     trajectories diverge). Each line states the state bytes of rank 0
     and of one device. Their step times are two ranks sharing one card's
     SMs with gloo reducing through the host: not tensor-parallel speed,
     and printed as such (``tp_step_seconds``);
 29. ``serve_mesh``: serving on a mesh. The paged kernel ``main`` at the
     shards' heads over a model extent of 2 (mistral-7b's 16 over 4,
     llava-next-34b's 28 over 4), pinned and on the device
     (``"path": "serve_mesh"``); then each ``SERVE_MESH_RUNS`` run on one
     device (its graph engine) and on two gloo ranks sharing the card,
     from seed 0's weights at full width, depths cut for the run's time:
     ``mesh_paged`` (mistral-7b, 8 of 32 layers, data 1 x model 2, the
     ``serve`` phase's paged plan and requests), ``mesh_sharded`` (1
     layer, data 2 x model 1, ``n_persist = 0``, a resident cache, 4
     requests of 8 to 15 tokens and 4 new: every step gathers the
     weights through the host) and ``mesh_mamba`` (mamba2-130m, 12 of
     24 layers, model 2, replay, prompts of 24 to 39 tokens). Each
     ``serve_mesh`` line: tokens/s and TTFT beside one device's (no
     serving speed: two processes on one card), peak, cache and
     cold-read bytes of rank 0 and of one device, rank 0's launches
     against the plan's count (exact), the teacher-forced gap to one
     device (8 seeded tokens on the cache the run filled, from the
     shortest prompt's length; within ``SERVE_MESH_TOL * (1 + max
     |logit|)``), the gap a planted split fault gives on the ranks
     (``SERVE_MESH_FAULTS``, which must exceed that bound) and the greedy
     tokens equal to one device's;
 30. ``launchers``: ``launch.train`` (mistral-7b, 32 layers, the searched
     plan as searched; seamless-m4t-large-v2; each 2 steps of B 1 at S
     4096) and ``launch.serve`` (mistral-7b, paged, its default stream)
     through their ``main(argv)``, each JSON line checked (finite losses;
     drained).

The kernels summary line gives each kernel's launches per path
(``launches_by_path``: each path's counts, zeroed just before it ran);
``launches`` stays each kernel's count on the path it came with;
``encdec_cases``: the flash and paged rows at seamless-m4t-large-v2's heads;
``vlm_cases``: every kernel's rows at llava-next-34b's shapes;
``dist_cases``: the quantizer's rows at the gradient sync's chunks;
``tp_cases``: the flash rows at the model axis's shard shapes, each with
its ``family``; ``serve_mesh_cases``: the paged rows at the serving
shards' heads.

The fused int8 quantize kernel (``fused_quantize_ef``) is held to its
plain version bitwise (q, scales and the residual) in phase 5 at
``QUANT_TRAIN_CASES`` (mistral-7b's sites, 4096 x 4096 bf16; the widest
configs' rows, d 16384 and 18432, bf16 and fp32; one row; the gradient
wire, 4 x 14,680,064 fp32; edge rows) and in phase 13 at
``QUANT_MAMBA_CASES`` (32,768 x 768 bf16, 257 rows, one row). Each case
prints its bound and the kernels one call launches (the kernel nodes of a
CUDA graph that captures it), which must be its plan's passes
(``kernels/fused_quant.quant_plan``: one kernel for every row width the
configs hold). The build phase fails if ptxas reports
a spill in the quantizer's kernels or compiled one that ``KERNEL_KINDS``
does not name. ``train_compare`` runs a second case under a ``compress8``
/ ``swap`` plan with the head's weights in host memory.

The ``dryrun`` phase, after ``launchers`` and with no card phase beside
it, runs the dry-run (``launch/dryrun.py``) in ``DRYRUN_WORKERS``
processes of its own, which share its tasks (fake tensors are host
work): every (architecture x shape) cell on both production meshes
planned on ``H100_SXM``'s data sheet and its step built on fake CUDA
tensors for rank 0 of 256 or 512 ranks (the kernel route: the kernels'
fakes), and the MegaTrain demo. It prints a line a cell and fails unless
all 66 are ``ok`` and no task launched a kernel or allocated on the card. ``dryrun_vs_card`` holds the fake builds of the
``train`` phase's step and of the ``engine`` phase's decode step to the
peaks those phases measured (``DRYRUN_VS_CARD_BOUND``). The ``tp``
phase's ``mistral_pod`` run puts its two gloo ranks on two pods of one
data rank each, under ZeRO-sharded ``hbm`` chunks (``tp_pod``).

Then the kernels summary line, the card's name and power limit, and last
the result line. Any failed check raises: the script exits non-zero and
prints no result line. It exits non-zero at once without CUDA, or outside a
checkout of the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent

# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W)
# and the host link (PCIe 5.0 x16, one direction).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # outside the tensor cores
BF16_FLOP_PER_S = 989e12  # dense tensor cores
HOST_LINK_BYTES_PER_S = 64e9

# Kernel vs plain version, bf16 outputs compared in fp32. RMSNorm outputs are of
# order 1: |k - p| <= RMSNORM_TOL * (1 + |p|), the repository's bf16 bound
# (tests/test_kernels.py: atol = rtol = 2e-2). Paged-attention outputs are
# softmax-weighted means of hundreds of rows, of order 0.05, so their bound
# scales with the output: |k - p| <= PAGED_TOL * max |p| over each (batch row,
# head), a few bf16 roundings of that head's output.
RMSNORM_TOL = 2e-2
PAGED_TOL = 2e-2
# Teacher-forced logits, kernels vs the plain path, bf16 through 32 layers:
# |diff| <= ENGINE_TOL * (1 + max |logit|).
ENGINE_TOL = 5e-2
# The same for qwen2-moe-a2.7b through 24 layers: twice ENGINE_TOL, since an
# MoE layer is discontinuous in its input. A
# router logit moved by bf16 noise (about 1e-2 of logits of std 0.9) can
# swap a token's 4th and 5th expert, or which token an expert's one
# capacity row takes, and so move that token's layer output by a choice's
# weighted expert output (about 0.25 x 0.6 an element), which the final
# norm and the head (std 0.02 over 2048) carry to the logits as about 0.05
# to 0.3. The greedy token must agree in every row whose plain top-1 leads
# its top-2 by more than that tolerance.
MOE_ENGINE_TOL = 1e-1

# FlashAttention kernels vs plain, bf16 compared in fp32: O, dQ, dK and dV
# within FLASH_TOL * max |plain| over each (batch, row, head) (a few bf16
# roundings of that row's values; a causal row's scale falls as 1/sqrt(q),
# so a wider scale would hide late rows), plus FLASH_FLOOR * max |plain|
# over the (batch, head) for rows near 0; the fp32 log-sum-exp within
# LSE_TOL * (1 + |plain|) (fp32 sums in another order).
FLASH_TOL, FLASH_FLOOR = 2e-2, 1e-4
FLASH_TOL_TEXT = (f"{FLASH_TOL} * max |plain| per (batch, row, head) "
                  f"+ {FLASH_FLOOR} * max |plain| per (batch, head)")
LSE_TOL = 1e-4
# Fused Adam vs plain: fp32 master, m and v within ADAM_TOL * (|plain| +
# max |plain|) (a few ulps: FMAs and the order of sqrt and divide); bf16 p
# within one bf16 ulp, 2^-7 * |plain|, plus the master's own bound (a master
# a few fp32 ulps off can round to the neighbouring bf16 value).
ADAM_TOL = 1e-6
# train_compare, kernels vs plain path, bf16 through 2 layers at S 4096.
LOSS_TOL, NORM_RTOL, GRAD_COSINE = 1e-2, 2e-2, 0.999
# Its plan case (compress8 and swap layers, host head weights) is held to the
# same bounds. Its compress8 sites quantize activations that the two paths
# compute with bf16 differences, so an int8 value may flip by one step where
# that noise crosses a rounding boundary; on an H100 80GB HBM3 at 700 W that
# moved the loss 1.98e-4 (resident 1.73e-4), the gradient norm 4.0e-5
# relative and the smallest leaf cosine to 0.99919 (resident 0.99991):
# inside the resident bounds, so nothing is loosened.
# train: the first loss of a random init lies near ln(vocab) = 10.37. The
# head's init (std 0.02) gives logits of std 0.02 * sqrt(4096) = 1.28 on
# unit-RMS hidden states, which lifts the log-sum-exp by about 1.28^2 / 2
# = 0.82: the band is 1.5 either way.
FIRST_LOSS_BAND = 1.5

SERVING_KERNELS = ("paged_attention", "rmsnorm")
TRAINING_KERNELS = ("flash_attention", "flash_attention_bwd", "rmsnorm", "fused_adam",
                    "fused_quantize_ef")

# The serving slice's shapes (mistral-7b: 32 query heads over 8 KV heads, hd 128).
BATCH, HQ, HKV, HD = 4, 32, 8, 128
SEQ_LEN, PAGE, N_HOT = 1024, 256, 2
PREFILL_CHUNK, NEW_TOKENS = 32, 16
PROMPT_LENS = (520, 800)  # past the 2-page hot window: cold pages are read
LONG_SEQ = 65536  # a long cache for the paged kernel alone (no S cap since split-KV)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _event_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` CUDA-event windows."""
    import torch

    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def time_ms(fn, reps: int = 15, inner: int = 10) -> tuple[float, float]:
    """Per-call time of ``fn`` on the card: (device ms, eager ms).

    Device ms replays ``inner`` calls captured in a CUDA graph, so it is the
    work's time on the card without the host's launch cost; eager ms times
    the same calls launched from Python (what one call costs the caller)."""
    import torch

    def eager():
        for _ in range(inner):
            fn()

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    eager_ms = _event_ms(eager, reps) / inner
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        eager()
    graph.replay()
    torch.cuda.synchronize()
    return _event_ms(graph.replay, reps) / inner, eager_ms


def timed(prefix: str, fn, **kw) -> dict:
    """``time_ms(fn, **kw)`` as ``{prefix: device ms, prefix's eager: eager ms}``."""
    device_ms, eager_ms = time_ms(fn, **kw)
    return {prefix: device_ms, prefix.replace("ms", "eager_ms"): eager_ms}


def max_excess(out, ref, tol) -> tuple[float, float]:
    """(max |out - ref|, max of |out - ref| - tol) in fp32; ``tol`` is a
    number or a tensor of ref's shape."""
    d = (out.float() - ref.float()).abs()
    return d.max().item(), (d - tol).max().item()


def phase_card() -> str:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("card", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    return smi


def ptxas_report(log: str) -> list[str]:
    """One line per compiled kernel from ``nvcc -Xptxas -v``: its (mangled)
    name, then its registers, shared memory and spills."""
    lines, name, spill = [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            spill = ""
    return lines


def source_log(log: str, source: str) -> str:
    """The part of the build log that compiled ``source``: from its ``$ nvcc``
    command line to the next command's."""
    parts = ("\n" + log).split("\n$ ")
    return "\n".join(p for p in parts if source in p.split("\n", 1)[0])


def spill_free(report_line: str) -> bool:
    """True when a ``ptxas_report`` line shows 0 bytes of spill stores and loads."""
    return re.search(r"\b0 bytes spill stores, 0 bytes spill loads", report_line) is not None


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    log = build.BUILD_INFO["log"]
    # e.g. C7514: ptxas serialized a kernel's wgmma, which costs its overlap
    notes = [line.strip() for line in log.splitlines() if "Performance Loss" in line]
    ptxas = ptxas_report(log)
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=build.BUILD_INFO["seconds"],
         built=build.BUILD_INFO["built"], lib=build.BUILD_INFO["lib"], ptxas=ptxas,
         ptxas_notes=notes, rmsnorm=[line for line in ptxas if "rmsnorm_kernel" in line])
    # the forward's loop keeps every wgmma and wait out of a branch so that
    # ptxas overlaps them; a note on it means that was lost
    fwd_notes = [n for n in notes if "flash_fwd_wgmma_kernel" in n]
    assert not fwd_notes, f"ptxas serialized the flash forward's wgmma: {fwd_notes}"
    # the quantizer holds its rows in registers: a spill would send them
    # through local memory, and a kernel the profile's map does not name
    # would leave its time unattributed
    quant = ptxas_report(source_log(log, "fused_quant.cu"))
    assert quant, "no ptxas report for fused_quant.cu"
    spills = [line for line in quant if not spill_free(line)]
    assert not spills, f"ptxas spilled in the quantizer's kernels: {spills}"
    unnamed = [line for line in quant if not any(k in line for k in QUANT_KERNELS)]
    assert not unnamed, f"quantizer kernels missing from KERNEL_KINDS: {unnamed}"


def rmsnorm_case(rows: int, gen, d: int = 4096) -> dict:
    """The kernel at ``rows`` x ``d`` bf16 (rows = BATCH: the decode step's
    shape; 4096: a training microbatch's; d 4096 mistral-7b's width, 2048
    qwen2-moe-a2.7b's), graph-replayed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import fused_rmsnorm
    from repro_torch.kernels.ref import rmsnorm_ref

    x = torch.randn(rows, 1, d, device="cuda", generator=gen).bfloat16()
    s = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).bfloat16()
    out = fused_rmsnorm(x, s)
    ref = rmsnorm_ref(x, s)
    torch.cuda.synchronize()
    err, excess = max_excess(out, ref, RMSNORM_TOL * (1 + ref.float().abs()))
    assert excess <= 0, f"rmsnorm rows={rows}: max |diff| {err} beyond tolerance"
    nbytes = 2 * x.numel() * x.element_size() + s.numel() * s.element_size()
    flops = 4 * x.numel()
    bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
    return {
        "rows": rows, "d": d, "max_abs_err": err, "tol": f"{RMSNORM_TOL} * (1 + |plain|)",
        **timed("ms", lambda: fused_rmsnorm(x, s)),
        **timed("plain_ms", lambda: rmsnorm_ref(x, s)),
        **timed("library_ms", lambda: F.rms_norm(x, (d,), weight=s, eps=1e-6)),
        "bound_ms": bound, "bound_bytes": nbytes,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOP_PER_S else "operations",
    }


def paged_inputs(case: str, cold_on_host: bool, gen, heads=(HQ, HKV), arch="mistral-7b",
                 hd: int = HD):
    """The paged kernel's inputs at the serving shapes of ``arch``, ``heads``
    (query, KV) heads of ``hd``. ``main`` takes sel and mask from
    ``PagedKV.prepare`` at mid-run positions of the arch's cache (past the
    hot window, so cold rows are attended); ``full`` masks by position
    without the ring rule; ``ring`` is a wrapped ring (every row attendable)
    with a random 50/50 sel; ``long`` is ``full`` over a cache of LONG_SEQ
    rows."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import kvcache as KV
    from repro_torch.serve.paging import PagedKV, choose_paging

    b, w = BATCH, PAGE * N_HOT
    hq, hkv = heads
    s = LONG_SEQ if case == "long" else SEQ_LEN
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).bfloat16()  # noqa: E731
    q, kh, vh = rnd(b, 1, hq, hd), rnd(b, w, hkv, hd), rnd(b, w, hkv, hd)
    kc, vc = rnd(b, s, hkv, hd), rnd(b, s, hkv, hd)
    pos = torch.tensor([530, 610, 700, 815])
    if case == "main":
        spec = choose_paging(s, PAGE, N_HOT)
        cache = {"pos0": {"k_hot": kh[None]}}
        step = PagedKV(spec).prepare(cache, pos, get_config(arch), "cuda")
        sel, mask = step.sel, step.mask
    elif case in ("full", "long"):
        if case == "long":
            pos = torch.tensor([40_000, 50_000, 60_000, LONG_SEQ - 1])
        sel = torch.rand(b, s, device="cuda", generator=gen) < 0.5
        mask = KV.decode_mask(pos, s, sliding=False).to("cuda")
    else:
        sel = torch.rand(b, s, device="cuda", generator=gen) < 0.5
        mask = torch.zeros(b, s, device="cuda")
    if cold_on_host:
        kc, vc = kc.cpu().pin_memory(), vc.cpu().pin_memory()
    return q, kh, vh, kc, vc, sel, mask


def paged_bound(args, cold_on_host: bool) -> tuple[float, str, dict]:
    """Least time for this input: the bytes the function must move (q, out,
    sel, mask, and K and V of every attended row from where it lies) and its
    fp32 operations, against HBM, the host link and the fp32 peak."""
    from repro_torch.serve.paging import attended_rows

    q, kh, vh, kc, vc, sel, mask = args
    hq, hkv, hd = q.shape[2], kh.shape[2], q.shape[3]
    valid = attended_rows(mask)
    row = 2 * hkv * hd * q.element_size()  # K and V of one cache row, all kv heads
    hot_rows = int((valid & sel).sum())
    cold_rows = int((valid & ~sel).sum())
    hbm = 2 * q.numel() * q.element_size() + sel.numel() + 4 * mask.numel() + hot_rows * row
    host = cold_rows * row if cold_on_host else 0
    if not cold_on_host:
        hbm += cold_rows * row
    flops = (hot_rows + cold_rows) * hq * hd * 4 + 5 * hq * mask.numel()
    times = {"bytes": max(hbm / HBM_BYTES_PER_S, host / HOST_LINK_BYTES_PER_S),
             "operations": flops / FP32_FLOP_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by, {"hbm_bytes": hbm, "host_bytes": host, "flops": flops}


def paged_library(args, **kw) -> dict:
    """The library yardsticks: SDPA over the cache gathered beforehand on the
    device (``library_ms``); for a pinned cold store also the same SDPA after
    copying, inside the timed call, the attended cold rows to the device
    (``library_with_copy_ms``). Those rows are packed beforehand into one
    pinned buffer, as a cache that copies would keep its cold pages, so the
    copy moves the kernel's host-link bytes and no more
    (``library_copy_bytes``, held equal to the bound's ``host_bytes``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.serve.paging import attended_rows

    q, kh, vh, kc, vc, sel, mask = args
    s = mask.shape[1]
    rows = torch.arange(s, device="cuda") % kh.shape[1]
    s4 = sel[..., None, None]
    kd, vd = kc.cuda(), vc.cuda()
    k = torch.where(s4, kh[:, rows], kd).transpose(1, 2)
    v = torch.where(s4, vh[:, rows], vd).transpose(1, 2)
    qt = q.transpose(1, 2)
    am = mask[:, None, None, :].to(q.dtype)
    lib = lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=am, enable_gqa=True)  # noqa: E731
    out = timed("library_ms", lib, **kw)
    if kc.device.type == "cuda":
        return out
    cold = (attended_rows(mask) & ~sel).flatten().nonzero().squeeze(1)  # b * S + s
    flat = lambda t: t.view(-1, *t.shape[2:])  # noqa: E731
    kp, vp = (flat(t)[cold.cpu()].pin_memory() for t in (kc, vc))
    kb, vb = torch.empty_like(kp, device="cuda"), torch.empty_like(vp, device="cuda")

    def copy_then_sdpa():
        kb.copy_(kp, non_blocking=True)
        vb.copy_(vp, non_blocking=True)
        flat(kd).index_copy_(0, cold, kb)
        flat(vd).index_copy_(0, cold, vb)
        kk = torch.where(s4, kh[:, rows], kd).transpose(1, 2)
        vv = torch.where(s4, vh[:, rows], vd).transpose(1, 2)
        return F.scaled_dot_product_attention(qt, kk, vv, attn_mask=am, enable_gqa=True)

    out.update(timed("library_with_copy_ms", copy_then_sdpa, **kw))
    out["library_copy_bytes"] = 2 * kp.numel() * kp.element_size()
    return out


def paged_case(case: str, cold_on_host: bool, gen, heads=(HQ, HKV),
               arch="mistral-7b", hd: int = HD, **kw) -> dict:
    """The paged kernel against its plain version on ``paged_inputs``;
    ``kw``: ``time_ms``'s repetitions."""
    import torch

    from repro_torch.kernels import decode_paged_attention
    from repro_torch.kernels.paged_attention import split_rows
    from repro_torch.kernels.ref import paged_attention_ref

    args = paged_inputs(case, cold_on_host, gen, heads, arch, hd)
    s = args[-1].shape[1]
    out = decode_paged_attention(*args, n_hot=N_HOT)
    ref = paged_attention_ref(*args)
    torch.cuda.synchronize()
    tol = PAGED_TOL * ref.float().abs().amax(dim=-1, keepdim=True)  # per (b, head)
    err, excess = max_excess(out, ref, tol)
    assert excess <= 0, (f"paged_attention {case} host={cold_on_host}: max |diff| {err} "
                         f"beyond {PAGED_TOL} * max |plain| of its head")
    bound, by, work = paged_bound(args, cold_on_host)
    rows, n_split = split_rows(BATCH, heads[1], s, PAGE,
                               torch.cuda.get_device_properties(0).multi_processor_count)
    res = {
        "case": case, "s": s, "heads": list(heads), "hd": hd,
        "cold": "pinned_host" if cold_on_host else "device",
        "n_split": n_split, "rows_per_split": rows,
        "max_abs_err": err, "max_abs_plain": ref.float().abs().max().item(),
        "tol": f"{PAGED_TOL} * max |plain| per (batch, head)", "tol_min": tol.min().item(),
        **timed("ms", lambda: decode_paged_attention(*args, n_hot=N_HOT), **kw),
        **timed("plain_ms", lambda: paged_attention_ref(*args), **kw),
        **paged_library(args, **kw), "bound_ms": bound, "bound_by": by, **work,
    }
    assert res.get("library_copy_bytes", 0) == res["host_bytes"], (
        f"paged_attention {case}: the copy yardstick moves {res.get('library_copy_bytes')} B, "
        f"the kernel reads {res['host_bytes']} B over the host link")
    return res


def host_link_rate() -> dict:
    """This machine's copy-engine rates over the host link, 256 MiB copies
    between pinned memory and the device, CUDA-event timed (median of 5,
    ``core.hardware.measure_host_link``): host to device (``gb_per_s``),
    device to host, and both at once on two streams (each way), the rate the
    pinned-state Adam's pipeline can reach. The paged kernel's host-cold
    reads are set beside them, and beside the 64 GB/s specification that
    ``paged_bound`` uses."""
    from repro_torch.core.hardware import measure_host_link

    n = 256 << 20
    link = measure_host_link("cuda", n)
    return {"bytes": n, "ms": n / link["h2d"] * 1e3, "gb_per_s": link["h2d"] / 1e9,
            "d2h_gb_per_s": link["d2h"] / 1e9, "both_ways_gb_per_s_each": link["both_ways"] / 1e9}


def phase_kernels() -> dict:
    import torch

    emit("host_link", **host_link_rate())
    gen = torch.Generator(device="cuda").manual_seed(0)
    rms = [rmsnorm_case(rows, gen) for rows in (BATCH, BATCH * 32, TRAIN_SEQ)]
    for r in rms:
        emit("kernel_vs_plain", kernel="rmsnorm", **r)
    from repro_torch.kernels.rmsnorm import empty_kernel_cuda

    # the least a launch costs, in the same graph-replay harness: the floor
    # under a decode-shape row's time
    dev = torch.device("cuda")
    emit("kernel_floor", kernel="empty", **timed("ms", lambda: empty_kernel_cuda(dev)))
    paged = [paged_case(case, host, gen)
             for case in ("main", "full", "ring", "long") for host in (True, False)]
    for p in paged:
        emit("kernel_vs_plain", kernel="paged_attention", **p)
    return {"rmsnorm": rms, "paged_attention": paged}


def _clone_cache(cache: dict) -> dict:
    import torch

    def clone(t):
        if t.device.type == "cpu" and t.is_pinned():
            return torch.empty_like(t, pin_memory=True).copy_(t)
        return t.clone()

    return {pos: {k: clone(v) for k, v in e.items()} for pos, e in cache.items()}


def step_account(engine, tokens, pos, reps: int = 10) -> dict:
    """The engine's captured step, timed two ways on the same inputs.

    ``eager_wall_ms``: host wall time of the step launched from Python, its
    indices built on the device as in the graph. ``graph_device_ms``: the
    same step replayed from the engine's CUDA graph, CUDA-event timed
    (``graph_wall_ms``: that replay's host wall time to a synchronise). Graph
    replay leaves gaps of its own, so ``1 - graph/eager`` is a lower bound
    on the share of an eager step in which the card waits for the host. The
    step rewrites the same token at the same slot each time, so every run
    sees the same cache."""
    import torch

    step = engine.serve_step
    assert step.graph is not None, "the engine did not capture its step"
    step.tokens[:, 0].copy_(tokens[:, 0])
    step.pos.copy_(pos)
    step.n_tok.fill_(1)

    def eager():
        step.t.zero_()
        with torch.inference_mode():
            step.step()

    def replay():
        step.t.zero_()
        step.graph.replay()

    def walls(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    wall_ms = walls(eager)
    graph_wall_ms = walls(replay)
    device_ms = _event_ms(replay, reps)
    return {"positions": pos.tolist(), "eager_wall_ms": wall_ms, "graph_device_ms": device_ms,
            "graph_wall_ms": graph_wall_ms,
            "device_idle_share_at_least": 1.0 - device_ms / wall_ms}


def tick_device_times(engine):
    """Wrap ``engine``'s ticks to time, on the card, the step replays each
    served tick runs: CUDA events around every ``replay_once`` (a graph's
    replay: its device time, whether or not earlier replays are still
    queued), summed per tick beside the tick's host wall time. Returns the
    per-kind list of ``(wall_ms, [(start, end) events])`` the run fills."""
    import torch

    ticks = {"decode": [], "prefill": []}
    step, replay_once = engine.serve_step, engine.serve_step.replay_once
    current = []

    def timed_replay():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        replay_once()
        end.record()
        current.append((start, end))

    def wrap(kind, tick):
        def run():
            current.clear()
            t0 = time.perf_counter()
            tick()
            if current:
                ticks[kind].append(((time.perf_counter() - t0) * 1e3, list(current)))
        return run

    step.replay_once = timed_replay
    engine._decode_tick = wrap("decode", engine._decode_tick)
    engine._prefill_tick = wrap("prefill", engine._prefill_tick)
    return ticks


def tick_account(ticks) -> dict:
    """Per tick kind: the median host wall time and device time of a tick,
    and the card's idle share over those ticks, 1 - device / wall summed."""
    out = {}
    for kind, rows in ticks.items():
        if not rows:  # (replay admission has no prefill ticks)
            continue
        walls = [w for w, _ in rows]
        devs = [sum(a.elapsed_time(b) for a, b in ev) for _, ev in rows]
        out[kind] = {"n": len(rows), "wall_median_ms": statistics.median(walls),
                     "device_median_ms": statistics.median(devs),
                     "idle_share": 1.0 - sum(devs) / sum(walls)}
    return out


def serve(engine, reqs, device_times: bool = False,
          kernels: tuple[str, ...] = SERVING_KERNELS, prime=None) -> dict:
    """Serve ``reqs`` on a warmed-up engine: its report, the launches of
    ``kernels`` over the run, the host wall time of its ticks by kind and,
    with ``device_times`` (a graph engine), each tick kind's device time and
    idle share (``tick_account``). ``prime(engine)``: called once every
    request holds its slot (admitted here, before the first tick, into the
    fresh engine's zeroed slots, so that no tick's admission zeroes what it
    writes), before the launch counts are zeroed."""
    import torch

    from repro_torch import kernels as K

    torch.cuda.synchronize()
    engine.tel.tracer.events.clear()
    ticks_dev = tick_device_times(engine) if device_times else None
    if prime is not None:
        engine.submit(reqs)
        assert sorted(engine.scheduler.admit()) == list(range(BATCH)), "a request waits"
        prime(engine)
        torch.cuda.synchronize()
        reqs = None
    K.reset_launch_counts()
    report = engine.run(reqs)
    torch.cuda.synchronize()
    launches = {k: K.launch_counts()[k] for k in kernels}
    assert report.drained, f"engine did not drain: pending {report.pending}"
    assert sorted(report.finished) == list(range(BATCH))
    assert all(len(t) == NEW_TOKENS for t in report.finished.values()), report.finished
    ticks = {}
    for name in ("serve.prefill_tick", "serve.decode_tick"):
        durs = [e["dur_s"] for e in engine.tel.tracer.events if e["name"] == name]
        ticks[name] = {"n": len(durs), "median_s": statistics.median(durs) if durs else None,
                       "total_s": sum(durs)}
    return {"report": report, "launches": launches, "ticks": ticks,
            "h2d_bytes": engine.tel.registry.snapshot()["serve.h2d_bytes"]["value"],
            "tick_device": tick_account(ticks_dev) if device_times else None}


def decode_norms(cfg) -> int:
    """RMSNorm launches of one decode step: each layer's (``layer_norms``)
    and the final norm."""
    return 1 + sum(layer_norms(cfg, i) for i in range(cfg.num_layers))


def serve_setup(cfg):
    """(shape, paging, plan, admission) of a serving phase: a model with
    attention paged (``PAGE``-row pages, ``N_HOT`` hot) under chunked
    admission, an attention-free one resident under replay."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import MemoryPlan
    from repro_torch.models import kvcache as KV
    from repro_torch.models.model import num_repeats
    from repro_torch.serve import choose_paging

    shape = ShapeConfig("smoke", SEQ_LEN, BATCH, "decode")
    n_chunks = num_repeats(cfg) + 2  # embedding + one per block + head
    if cfg.attention_free:
        plan = MemoryPlan(n_chunks, num_repeats(cfg), n_persist=n_chunks)
        return shape, None, plan, dict(admission="replay")
    spec = choose_paging(KV.cache_len(cfg, SEQ_LEN), PAGE, N_HOT)
    assert (spec.page_size, spec.n_pages, spec.n_hot) == (PAGE, SEQ_LEN // PAGE, N_HOT)
    plan = MemoryPlan(n_chunks, num_repeats(cfg), n_persist=n_chunks, n_host=spec.n_cold)
    return shape, spec, plan, dict(admission="chunked", prefill_chunk=PREFILL_CHUNK)


def serve_phase(cfg, hw, phase: str, prompt_lens=PROMPT_LENS, prime=None, params=None,
                record: dict | None = None) -> dict[str, int]:
    """``DecodeEngine`` serving 4 requests of ``cfg`` (random bf16 weights
    from seed 0), from its CUDA graph, then from Python (tokens and launches
    equal), a teacher-forced step through the kernels against the plain
    path, and the captured step timed eagerly and replayed. A model with
    attention is served on the paged plan under chunked admission; an
    attention-free one (Mamba-2) on the resident plan under replay
    admission, the engine's default. For an MoE ``cfg`` the teacher-forced
    check is MOE_ENGINE_TOL's and the routing choices of the two paths are
    compared (``routing``). The plain path's RMSNorm is the plain version
    (``plain_rmsnorm``); a LayerNorm model launches no RMSNorm. ``prime``:
    ``serve``'s hook, run on both engines (an encoder-decoder's cross
    cache); then the graph engine's step is replayed over the primed cache
    and over a zeroed one, whose logits must differ (``priming``).
    ``params``: the weights to serve (default: drawn here); ``record``: a
    dict given the prompts and the graph engine's tokens."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.models import kvcache as KV
    from repro_torch.models.model import init_params
    from repro_torch.serve import DecodeEngine, PagedKV, Request

    moe = cfg.moe is not None
    attn = not cfg.attention_free
    rms = cfg.norm == "rmsnorm"
    kernels = tuple(k for k in (SERVING_KERNELS if attn else ("rmsnorm",))
                    if k != "rmsnorm" or rms)
    shape, spec, plan, admission = serve_setup(cfg)
    t0 = time.perf_counter()
    if params is None:
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def make_engine(graphs: bool):
        # the eager engine shares the weights (own_params: no copy); each has its cache
        t0 = time.perf_counter()
        eng = DecodeEngine(cfg, plan, "cuda", shape, params, paging=spec, own_params=True,
                           **admission, telemetry=obs.Telemetry(),
                           graphs=graphs)  # spans: wall per tick
        eng.warmup()
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t0

    rng = np.random.default_rng(0)
    lens = rng.integers(*prompt_lens, size=BATCH)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist() for n in lens]
    reqs = lambda: [Request(i, p, NEW_TOKENS) for i, p in enumerate(prompts)]  # noqa: E731
    engine, capture_s = make_engine(graphs=True)
    assert engine.serve_step.graph is not None, "on CUDA the engine serves from a graph"
    torch.cuda.reset_peak_memory_stats()
    run = serve(engine, reqs(), device_times=True, kernels=kernels, prime=prime)
    report, launches = run["report"], run["launches"]
    peak = torch.cuda.max_memory_allocated()
    if record is not None:
        record.update(prompts=prompts, finished=report.finished, peak_device_bytes=peak)
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched by the {phase} run"
    # per step: one paged attention an attention layer; the layers' RMSNorms
    # and the final one (``decode_norms``)
    n_attn = sum(cfg.mixer_at(i) == "attention" for i in range(cfg.num_layers))
    if attn and rms:
        assert launches["rmsnorm"] * n_attn == launches["paged_attention"] * decode_norms(
            cfg), launches
    if attn:
        assert launches["paged_attention"] % n_attn == 0, launches
        cold = next(e for e in engine.state["cache"].values() if "k_cold" in e)["k_cold"]
        assert cold.device.type == "cpu" and cold.is_pinned(), "cold store must be pinned host"
    if not attn:  # replay admission: one step a decode tick
        assert launches["rmsnorm"] == report.decode_ticks * decode_norms(cfg), (
            launches, report.decode_ticks)
    state_bytes = sum(leaf.numel() * leaf.element_size()
                      for e in engine.state["cache"].values() if "ssm" in e
                      for leaf in e.values())

    eager_engine, _ = make_engine(graphs=False)
    eager = serve(eager_engine, reqs(), kernels=kernels, prime=prime)
    assert eager["report"].finished == report.finished, "graph and eager engines' tokens differ"
    assert eager["launches"] == launches, (eager["launches"], launches)
    assert eager["h2d_bytes"] == run["h2d_bytes"], (eager["h2d_bytes"], run["h2d_bytes"])
    del eager_engine

    # one teacher-forced decode step, kernels vs the plain path, on copies
    # of the served cache at positions whose attended rows reach cold pages;
    # an MoE's routing choices recorded layer by layer
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (BATCH, 1))).cuda()
    pos = torch.tensor([int(n) + NEW_TOKENS - 1 for n in lens])
    outs, routes = {}, {}
    for use_kernel in (True, False):
        routes[use_kernel] = []
        norm = contextlib.nullcontext() if use_kernel else plain_rmsnorm()
        cache = _clone_cache(engine.state["cache"])
        with torch.inference_mode(), norm, routing_choices(routes[use_kernel]):
            logits, _ = KV.decode_step(engine.state["params"], cache, tokens, pos, cfg,
                                       kv_io=PagedKV(spec, use_kernel=use_kernel)
                                       if spec else None)
        outs[use_kernel] = logits.float()
    err = (outs[True] - outs[False]).abs().max().item()
    scale = outs[False].abs().max().item()
    agree_rows = outs[True].argmax(-1) == outs[False].argmax(-1)
    agree = agree_rows.float().mean().item()
    tol = (MOE_ENGINE_TOL if moe else ENGINE_TOL) * (1 + scale)
    top2 = outs[False].topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]  # the plain path's top-1 over top-2, per row
    teacher = {"max_abs_diff": err, "max_abs_logit": scale, "tol": tol, "argmax_agree": agree}
    if moe:
        same = [(a == b).float().mean().item() for a, b in zip(routes[True], routes[False])]
        teacher.update(top2_margin=margin.tolist(), rows_past_margin=int((margin > tol).sum()),
                       routing={"layers": len(same), "choices": BATCH * cfg.moe.top_k,
                                "agree_share": sum(same) / len(same),
                                "layers_all_agree": sum(x == 1.0 for x in same),
                                "first_layer_differing": next(
                                    (i for i, x in enumerate(same) if x < 1.0), None)})
    # the served cache itself (the run is over): the step writes position
    # lens + 16 - 1, which no request reached
    priming = None if prime is None else priming_reaches_graph(engine, tokens, pos)
    account = step_account(engine, tokens, pos)
    eager_report = eager["report"]
    emit(phase, arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         params=cfg.param_count(), init_s=init_s, capture_s=capture_s,
         paging=[spec.page_size, spec.n_pages, spec.n_hot] if spec else None,
         mamba_state_bytes=state_bytes,
         prompt_lens=[int(n) for n in lens], launches=launches, **report.to_dict(),
         hbm_cache_bytes=report.hbm_cache_bytes, host_cache_bytes=report.host_cache_bytes,
         peak_device_bytes=peak, ticks=run["ticks"], h2d_bytes=run["h2d_bytes"],
         decode_tick_median_ms=1e3 * run["ticks"]["serve.decode_tick"]["median_s"],
         tick_device=run["tick_device"],
         eager={"tokens_equal": True, "launches": eager["launches"], "ticks": eager["ticks"],
                **{k: v for k, v in eager_report.to_dict().items()
                   if k in ("wall_s", "tokens_per_s", "p50_ttft_s", "p99_ttft_s", "steps")}},
         teacher_forced=teacher, decode_step=account, priming=priming)
    if phase == "engine":
        # the prefill chunk the cost model would pick for this engine on this
        # card (the engine keeps its explicit PREFILL_CHUNK, for comparable numbers)
        from repro_torch.core.cost_model import choose_prefill_chunk
        from repro_torch.core.hardware import ONE_CHIP

        chosen = choose_prefill_chunk(cfg, shape, ONE_CHIP, hw, spec=spec,
                                      max_chunk=spec.page_size, kernel=True)
        emit("engine_prefill_chunk", explicit=PREFILL_CHUNK, choose_prefill_chunk=chosen,
             hw=hw.name, host_bw=hw.host_bw, paging=[spec.page_size, spec.n_pages, spec.n_hot])
    assert err <= tol, (
        f"teacher-forced logits: kernels vs plain differ by {err} (max |logit| {scale})")
    if moe:
        assert bool(agree_rows[margin > tol].all()), (
            f"teacher-forced greedy tokens differ in a row past the margin: {teacher}")
    else:
        assert agree == 1.0, f"teacher-forced greedy tokens differ in {1 - agree:.0%} of rows"
    return launches


def priming_reaches_graph(engine, tokens, pos) -> dict:
    """The graph engine's captured step replayed at ``pos`` over the primed
    cross cache, then with ``xk`` / ``xv`` zeroed in place, then primed again
    (the bytes put back): the logits of the first and last replays must be
    equal, and differ from the zeroed cache's."""
    import torch

    step = engine.serve_step
    step.tokens[:, 0].copy_(tokens[:, 0])
    step.pos.copy_(pos)
    step.n_tok.fill_(1)

    def replay():
        step.t.zero_()
        step.last.zero_()
        step.graph.replay()
        return step.last.float().clone()

    cross = [e[k] for e in engine.state["cache"].values() for k in ("xk", "xv")]
    primed = replay()
    kept = [t.clone() for t in cross]
    for t in cross:
        t.zero_()
    zeroed = replay()
    for t, k in zip(cross, kept):
        t.copy_(k)
    again = replay()
    torch.cuda.synchronize()
    out = {"max_abs_diff_primed_vs_zero": (primed - zeroed).abs().max().item(),
           "argmax_differs_rows": int((primed.argmax(-1) != zeroed.argmax(-1)).sum()),
           "primed_replays_equal": bool(torch.equal(primed, again)),
           "cross_cache_abs_max": max(t.float().abs().max().item() for t in cross)}
    assert out["primed_replays_equal"], out
    assert out["max_abs_diff_primed_vs_zero"] > 0, f"priming did not reach the graph: {out}"
    return out


def phase_engine(hw, record: dict | None = None) -> dict[str, int]:
    """``mistral-7b`` at full width and depth through ``serve_phase``."""
    from repro_torch.configs import get_config

    return serve_phase(get_config("mistral-7b"), hw, "engine", record=record)


# ---------------------------------------------------------------------------
# The training slice
# ---------------------------------------------------------------------------
TRAIN_SEQ, WINDOW = 4096, 4096


def eager_ms(fn, reps: int = 5, inner: int = 3) -> float:
    """Device time per call of ``fn`` launched from Python: CUDA events around
    ``inner`` calls, median of ``reps`` windows, after one warm-up call.
    For calls of a millisecond and more, where launch cost is noise."""
    import torch

    fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(inner):
            fn()

    return _event_ms(window, reps) / inner


def attended_pairs(s: int, window: int) -> int:
    """(q, k) pairs with k <= q and k > q - window, over one head."""
    return sum(min(q + 1, window) if window else q + 1 for q in range(s))


def row_excess(out, ref) -> tuple[float, float, float]:
    """For (B, S, H, hd) tensors: (max |out - ref|, max of |out - ref| less
    its tolerance, and the largest share of the tolerance used). The
    tolerance: FLASH_TOL * max |ref| per (batch, row, head) + FLASH_FLOOR *
    max |ref| per (batch, head)."""
    mag = ref.float().abs()
    tol = FLASH_TOL * mag.amax(dim=3, keepdim=True) + FLASH_FLOOR * mag.amax(dim=(1, 3),
                                                                             keepdim=True)
    err, excess = max_excess(out, ref, tol)
    share = ((out.float() - ref.float()).abs() / tol).max().item()
    return err, excess, share


def flash_case(s: int, gen, with_bwd: bool, heads=(HQ, HKV), window=WINDOW, hd: int = HD,
               causal: bool = True, sk: int | None = None) -> list[dict]:
    """Flash forward (and backward) at B 1, ``s`` query rows over ``sk``
    key rows (default ``s``), ``heads`` (query, KV) of ``hd``, causal or
    not, ``window`` (0: none)."""
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels as K
    from repro_torch.kernels import ref
    hq, hkv = heads
    sk = s if sk is None else sk
    mask = dict(causal=causal, window=window)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).bfloat16()  # noqa: E731
    q, k, v, dout = rnd(1, s, hq, hd), rnd(1, sk, hkv, hd), rnd(1, sk, hkv, hd), rnd(1, s, hq, hd)
    bhsd = lambda t: t.transpose(1, 2)  # noqa: E731
    out, lse = K.flash_attention(q, k, v, **mask)
    want = bhsd(ref.flash_attention_ref(bhsd(q), bhsd(k), bhsd(v), **mask))
    _, want_lse = ref.attention_lse_ref(q, k, v, **mask)
    torch.cuda.synchronize()
    err, excess, tol_share = row_excess(out, want)
    lse_err, lse_excess = max_excess(lse, want_lse, LSE_TOL * (1 + want_lse.abs()))
    what = f"S={s} Sk={sk} hd={hd} causal={causal}"
    assert excess <= 0, (f"flash forward {what}: max |diff| {err} beyond tolerance "
                         f"({tol_share} of the tolerance)")
    assert lse_excess <= 0, f"flash forward {what}: lse max |diff| {lse_err} beyond {LSE_TOL}"
    pairs = attended_pairs(s, window) if causal else s * sk
    qt, kt, vt = bhsd(q), bhsd(k), bhsd(v)
    if not causal:
        assert not window, "a window without the causal mask is not a case of the model's"
        sdpa_mask = {}
    elif not window or s <= window:  # the window cuts nothing: SDPA's own causal mask is ours
        sdpa_mask = dict(is_causal=True)
    else:  # an explicit band: k <= q and k > q - window
        qi = torch.arange(s, device="cuda")[:, None]
        ki = torch.arange(s, device="cuda")[None, :]
        sdpa_mask = dict(attn_mask=(ki <= qi) & (ki > qi - window))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,  # noqa: E731
                                                  **sdpa_mask)
    flops = 4 * hd * hq * pairs
    case = {"s": s, "sk": sk, "hd": hd, "causal": causal, "heads": list(heads),
            "window": window, "pairs": pairs}
    rows = [{
        "kernel": "flash_attention", **case,
        "max_abs_err": err, "max_abs_plain": want.float().abs().max().item(),
        "tol_share": tol_share, "tol": FLASH_TOL_TEXT, "lse_max_abs_err": lse_err,
        "lse_tol": f"{LSE_TOL} * (1 + |plain|)",
        "ms": eager_ms(lambda: K.flash_attention(q, k, v, **mask)),
        "plain_ms": eager_ms(lambda: ref.flash_attention_ref(
            bhsd(q), bhsd(k), bhsd(v), **mask), reps=3, inner=1),
        "library_ms": eager_ms(sdpa),
        "bound_ms": flops / BF16_FLOP_PER_S * 1e3, "bound_by": "operations", "flops": flops,
    }]
    if not with_bwd:
        return rows
    grads = K.flash_attention_bwd(q, k, v, out, lse, dout, **mask)
    wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **mask)
    torch.cuda.synchronize()
    errs, shares = {}, {}
    for name, got, exp in zip(("dq", "dk", "dv"), grads, wants):
        e, ex, shares[name] = row_excess(got, exp)
        assert ex <= 0, (f"flash backward {what}: {name} max |diff| {e} beyond tolerance "
                         f"({shares[name]} of it)")
        errs[name] = e
    del grads, wants
    ql, kl, vl = (t.detach().requires_grad_() for t in (qt, kt, vt))
    ol = F.scaled_dot_product_attention(ql, kl, vl, enable_gqa=True, **sdpa_mask)
    dol = bhsd(dout)
    library = eager_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), dol, retain_graph=True))
    del ol
    flops = 10 * hd * hq * pairs
    rows.append({
        "kernel": "flash_attention_bwd", **case,
        "max_abs_err": max(errs.values()), **{f"{k}_max_abs_err": e for k, e in errs.items()},
        **{f"{k}_tol_share": r for k, r in shares.items()}, "tol": FLASH_TOL_TEXT,
        "ms": eager_ms(lambda: K.flash_attention_bwd(q, k, v, out, lse, dout, **mask)),
        "plain_ms": eager_ms(lambda: ref.flash_attention_bwd_ref(
            q, k, v, out, lse, dout, **mask), reps=3, inner=1),
        "library_ms": library,
        "bound_ms": flops / BF16_FLOP_PER_S * 1e3, "bound_by": "operations", "flops": flops,
    })
    return rows


def adam_case(on_host: bool, gen, shape=(4096, 14336), fp32: bool = False) -> dict:
    """Fused Adam on one leaf: by default a w1 leaf of mistral-7b (4096 x
    14336); (60, 2048, 1408) is one layer's expert w1 of qwen2-moe-a2.7b.
    ``fp32``: an fp32 leaf (p and its gradient fp32, as mamba2-130m's
    ``A_log``, ``D`` and ``dt_bias``, 24 x 24 stacked over the layers)."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.kernels import fused_adam, ref
    from repro_torch.optim.adam import AdamConfig, adam_scalars

    n = math.prod(shape)
    # a leaf mid-training: weights of std 0.02, gradients of 1e-3, m and v
    # of the gradients' scale (v away from 0, where Adam's step is unbounded)
    master = 0.02 * torch.randn(*shape, device="cuda", generator=gen)
    g = 1e-3 * torch.randn(*shape, device="cuda", generator=gen)
    m = 1e-4 * torch.randn(*shape, device="cuda", generator=gen)
    v = 1e-6 * (0.5 + torch.rand(*shape, device="cuda", generator=gen))
    p = master.clone() if fp32 else master.bfloat16()
    g = g if fp32 else g.bfloat16()
    cfg = AdamConfig(lr=3e-4, weight_decay=0.1)
    scalars = adam_scalars(cfg, cfg.lr, 3, "cuda")
    lr, b1, b2, eps, wd, bc1, bc2, _ = scalars.tolist()
    want = ref.fused_adam_ref(p, g, master, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
                              weight_decay=wd, bc1=bc1, bc2=bc2)
    states = [t.clone() for t in (master, m, v)]
    if on_host:
        states = [torch.empty(shape, pin_memory=True).copy_(t) for t in states]
    got = K.fused_adam_update(p.clone(), g, *states, scalars)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b in zip(("master", "m", "v"), got[1:], want[1:]):
        b = b.to(a.device)
        errs[name] = max_excess(a, b, ADAM_TOL * (b.abs() + b.abs().max()))
    master_tol = ADAM_TOL * 2 * want[1].abs().max()
    errs["p"] = max_excess(got[0], want[0], (0.0 if fp32 else 2.0 ** -7) * want[0].float().abs()
                           + master_tol)
    for (name, (e, ex)), a, b in zip(errs.items(), got[1:] + got[:1], want[1:] + want[:1]):
        if ex > 0:
            i = (a.float().to(b.device) - b.float()).abs().argmax()
            at = {t: x.flatten()[i].item() for t, x in (("kernel", a.to(b.device)), ("plain", b),
                                                        ("master", master), ("g", g),
                                                        ("m", m), ("v", v))}
            raise AssertionError(f"fused_adam host={on_host}: {name} max |diff| {e} beyond "
                                 f"tolerance, at {at}")
    del want
    # read g, master, m, v; write p, master, m, v
    dev_bytes = (g.element_size() + p.element_size() + 24) * n
    if on_host:
        host = 12 * n  # master, m, v each way over the link
        times = {"bytes": max(host / HOST_LINK_BYTES_PER_S, 4 * n / HBM_BYTES_PER_S)}
    else:
        times = {"bytes": dev_bytes / HBM_BYTES_PER_S}
    times["operations"] = 12 * n / FP32_FLOP_PER_S
    by = max(times, key=times.get)
    # yardstick: torch's fused Adam on the same fp32 leaf on the device (it
    # writes no bf16 copy, so it does less work)
    lib_p = torch.nn.Parameter(master.clone())
    lib_p.grad = g.float()
    opt = torch.optim.Adam([lib_p], lr=3e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                           fused=True)
    pc = p.clone()
    row = {
        "kernel": "fused_adam", "states": "pinned_host" if on_host else "device",
        "shape": list(shape), "p_dtype": str(p.dtype).split(".")[-1],
        "max_abs_err": max(e for e, _ in errs.values()),
        **{f"{k}_max_abs_err": e for k, (e, _) in errs.items()},
        "tol": f"fp32 {ADAM_TOL} * (|plain| + max |plain|); p "
               + ("the master's" if fp32 else "2^-7 * |plain| + master's"),
        "ms": eager_ms(lambda: K.fused_adam_update(pc, g, *states, scalars)),
        "plain_ms": eager_ms(lambda: ref.fused_adam_ref(
            p, g, master, m, v, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=wd, bc1=bc1,
            bc2=bc2)),
        "library_ms": eager_ms(opt.step), "library": "torch.optim.Adam(fused=True), fp32 leaf "
        "on the device, no bf16 copy",
        "bound_ms": times[by] * 1e3, "bound_by": by,
        "device_bytes": dev_bytes if not on_host else 4 * n, "host_bytes": 24 * n if on_host else 0,
    }
    if on_host:
        # the same host bytes for the library: master, m and v copied in, the
        # fused Adam on the device leaf, the three copied back
        lib_state = opt.state[lib_p]
        dev = [lib_p.data, lib_state["exp_avg"], lib_state["exp_avg_sq"]]

        def copy_adam_copy():
            for d, h in zip(dev, states):
                d.copy_(h, non_blocking=True)
            opt.step()
            for d, h in zip(dev, states):
                h.copy_(d, non_blocking=True)

        row.update(library_with_copy_ms=eager_ms(copy_adam_copy),
                   library_copy_bytes=2 * sum(t.numel() * t.element_size() for t in dev),
                   segment_elements=fused_adam.SEGMENT, segments=len(fused_adam.segments(n)),
                   staging_bytes=fused_adam.staging_bytes(g.device))
        assert row["library_copy_bytes"] == row["host_bytes"], (
            f"fused_adam: the copy yardstick moves {row['library_copy_bytes']} B, the kernel's "
            f"pipeline {row['host_bytes']} B")
    return row


QUANT_WIRE = (4, 14_680_064)  # one w1 leaf of mistral-7b (4096 x 14336) in 4 chunks
# (case, shape) of the quantizer's cases in the training kernels' phase:
# mistral-7b's sites (4096 tokens x d 4096), llama3-405b's and
# nemotron-4-340b's widths (d 16384, 18432) in bf16 and, at 18432, fp32
# rows; one row (z = 1); the gradient wire; edge rows (``quant_inputs``).
QUANT_TRAIN_CASES = (("activation", (4096, 4096)), ("activation", (4096, 16384)),
                     ("activation", (4096, 18432)), ("activation_fp32", (1024, 18432)),
                     ("activation", (1, 18432)), ("wire", QUANT_WIRE),
                     ("edges", (4, 4099)), ("edges_bf16", (4, 4100)),
                     ("edges_long", (4, 20_001)))
QUANT_MAIN = ("activation", [4096, 4096])  # the summary line's row
# the quantizer's kernels by name (csrc/fused_quant.cu): one pass, two passes
QUANT_KERNELS = ("quant_rows_kernel", "segment_absmax_kernel", "segment_quant_kernel")


def quant_inputs(case: str, gen, shape):
    """(x, me) of a fused_quantize_ef case of ``shape`` (z, n).
    ``activation``: a site tensor of the training path (tokens x d_model)
    in bf16, rows of varied scale (``activation_fp32``: the same in fp32);
    ``wire``: the gradient-wire chunks, fp32 (``wire_own``: a rank's own
    chunk, z = 1, me 0); ``edges``, ``edges_bf16`` and
    ``edges_long``: a zero row, exact half-way quotients, values at the
    clip bound and a random row, in fp32 at n 4099 (not a multiple of 4:
    one value a load, one pass) and 20,001 (two passes), and in bf16 at n
    4100 (n % 8 == 4: 8-byte loads)."""
    import torch

    z, n = shape
    if case in ("activation", "activation_fp32"):
        scale = torch.exp(torch.randn(z, 1, device="cuda", generator=gen))
        x = torch.randn(z, n, device="cuda", generator=gen) * scale
        return (x if case == "activation_fp32" else x.bfloat16()), 0
    if case in ("wire", "wire_own"):  # wire_own: the rank's own chunk is chunk 0 (z = 1)
        return 1e-3 * torch.randn(z, n, device="cuda", generator=gen), 0 if z == 1 else 2
    ties = torch.zeros(n, device="cuda")
    ties[0] = 127.0  # the scale is exactly 1: x / scale is x
    ties[1:9] = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5])
    ties[9] = -0.0  # q 0; the residual keeps the sign of x: -0.0 - 0.0 * scale
    clip = torch.linspace(-3.3, 3.3, n, device="cuda")
    rnd = torch.randn(n, device="cuda", generator=gen)
    x = torch.stack([torch.zeros(n, device="cuda"), ties, clip, rnd])
    return (x.bfloat16() if case == "edges_bf16" else x), 1


def graph_kernel_nodes(fn) -> tuple[int, int]:
    """(kernel nodes, all nodes) of a CUDA graph that captures one call of
    ``fn``: the kernels the call launches. Counted in the graph, not traced:
    torch.profiler stopped seeing the library's launches in short traces
    after a profiled step (a 32,768 x 768 call came back with no kernel)."""
    import ctypes

    import torch

    fn()  # warm: the caching allocator's blocks come from outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    rt = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")  # torch's runtime
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    assert rt.cudaGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert rt.cudaGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    graph.reset()
    return kinds.count(0), len(kinds)  # 0: cudaGraphNodeTypeKernel


def quant_case(case: str, gen, shape) -> dict:
    """fused_quantize_ef against its plain version, bitwise, at ``shape``;
    one call must launch the plan's passes (one kernel when a row fits one
    pass) and nothing else."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_quant import quant_plan

    x, me = quant_inputs(case, gen, shape)
    got = K.fused_quantize_ef(x, me)
    want = ref.fused_quantize_ef_ref(x, me)
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t  # noqa: E731
    mismatches = {name: int((bits(a) != bits(b)).sum())
                  for name, a, b in zip(("q", "scales", "err"), got, want)}
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    assert not any(mismatches.values()), f"fused_quantize_ef {case}: not bitwise: {mismatches}"
    if case.startswith("edges"):
        q = got[0]
        assert q[1, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -126], q[1, 1:9].tolist()
        assert got[1][0].item() == (torch.tensor(1e-30, dtype=torch.float32) / 127).item()
    z, n = x.shape[0], x[0].numel()
    plan = quant_plan(z, n, x.dtype)
    kernel = lambda: K.fused_quantize_ef(x, me)  # noqa: E731
    plain = lambda: ref.fused_quantize_ef_ref(x, me)  # noqa: E731
    launched = graph_kernel_nodes(kernel)
    assert launched == (plan.passes, plan.passes), (
        f"fused_quantize_ef {case} {shape}: one call is {launched} (kernel, all) graph "
        f"nodes, the plan {plan.passes} pass(es)")
    # read x once; write q, the (z,) scales and one row's residual
    nbytes = x.numel() * x.element_size() + x.numel() + 4 * z + 4 * n
    flops = 5 * x.numel()  # abs, max, divide, round, clip
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": flops / FP32_FLOP_PER_S}
    by = max(times, key=times.get)
    if case.startswith("wire"):  # milliseconds: launch cost is noise, no graph pool of copies
        t = {"ms": eager_ms(kernel), "plain_ms": eager_ms(plain)}
    else:
        t = {**timed("ms", kernel), **timed("plain_ms", plain)}
    return {"kernel": "fused_quantize_ef", "case": case, "shape": [z, n],
            "dtype": str(x.dtype).replace("torch.", ""), "me": me, "max_abs_err": err,
            "mismatches": mismatches, "tol": "bitwise", **t, "library_ms": None,
            "library": "none: no single PyTorch call computes it",
            "bound_ms": times[by] * 1e3, "bound_by": by, "bound_bytes": nbytes,
            "bound_share": times[by] * 1e3 / t["ms"], "passes": plan.passes,
            "kernels_per_call": launched[0], "plan": dataclasses.asdict(plan)}


def phase_train_kernels() -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    quant = [lambda c=c, s=s: [quant_case(c, gen, s)] for c, s in QUANT_TRAIN_CASES]
    for case in [lambda: flash_case(TRAIN_SEQ, gen, True), lambda: flash_case(8192, gen, True),
                 lambda: flash_case(1000, gen, False), lambda: [adam_case(False, gen)],
                 lambda: [adam_case(True, gen)]] + quant:
        for r in case():
            emit("kernel_vs_plain", **r)
            rows.append(r)
        torch.cuda.empty_cache()
    main_rows = {}
    for r in rows:
        key = r["kernel"]
        if (r.get("s") == TRAIN_SEQ or r.get("states") == "device"
                or (r.get("case"), r.get("shape")) == QUANT_MAIN):
            main_rows[key] = r
    errs = {k: max(r["max_abs_err"] for r in rows if r["kernel"] == k) for k in main_rows}
    return {k: {**r, "max_abs_err": errs[k]} for k, r in main_rows.items()}


class plain_rmsnorm:
    """Inside: the model's RMSNorm is its plain version on CUDA tensors too
    (``ref.rmsnorm_ref``, differentiated by autograd), for the plain path of
    a comparison whose kernels include RMSNorm."""

    def __enter__(self):
        from repro_torch.kernels import ref
        from repro_torch.models import layers as L

        self.saved = L.fused_rmsnorm
        L.fused_rmsnorm = ref.rmsnorm_ref
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L

        L.fused_rmsnorm = self.saved


@contextlib.contextmanager
def routing_choices(choices: list, replay: bool = False):
    """Inside, the MoE layers' top-k gating appends its expert indices to
    ``choices``, call by call; with ``replay`` it takes them from
    ``choices`` instead and gates on them: the chosen experts'
    probabilities, normalized, and the aux loss of those choices, as
    ``models/moe._top_k_gating`` computes them from its own."""
    import torch

    from repro_torch.models import moe as MOE

    gating = MOE._top_k_gating
    given = iter(list(choices))

    def record(logits, top_k, route=None):
        out = gating(logits, top_k, route)
        choices.append(out[1].clone())
        return out

    def pinned(logits, top_k, route=None):
        assert route is None, "routing_choices pins one device's routing"
        indices = next(given)
        probs = torch.softmax(logits, dim=-1)
        weights = probs.gather(-1, indices)
        weights = weights / weights.sum(dim=-1, keepdim=True)
        one_hot = MOE._one_hot(indices, logits.shape[-1])
        aux = logits.shape[-1] * (one_hot.sum(dim=1).mean(dim=0) * probs.mean(dim=0)).sum()
        return weights, indices, one_hot, aux

    MOE._top_k_gating = pinned if replay else record
    try:
        yield
    finally:
        MOE._top_k_gating = gating
    assert not replay or next(given, None) is None, "the replayed path made fewer MoE calls"


def leaf_paths(tree, prefix: str = "") -> list[str]:
    """The paths of a tree's leaves in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}[{i}]")]
    return [prefix]


def compare_step(cfg, shape, plan, steps: int = 1, pin_routing: bool = False) -> dict:
    """``steps`` training steps of ``plan`` from one cloned state on one
    batch through the kernels (``attn_impl="blockwise"``,
    ``use_fused_kernel=True``) and through the plain path (``"naive"``,
    ``False``, and the plain RMSNorm): the first step's
    losses, gradient norms and each leaf's gradient cosine, every step's
    loss, and the kernels' launches over the kernels' steps. With
    ``pin_routing`` the plain path's MoE layers route as the kernels' did,
    call by call (``routing_choices``)."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.optim.adam import AdamConfig, tree_leaves, tree_map
    from repro_torch.train.step_builder import build_train_step

    clone = lambda tree: tree_map(lambda t: t.detach().clone(), tree)  # noqa: E731
    batch = SyntheticTokenPipeline(cfg, shape, seed=0, device="cuda").next_sync()
    init = None
    out = {}
    choices = []  # the kernels path's routing, call by call
    for way, impl, fused in (("kernels", "blockwise", True), ("plain", "naive", False)):
        norm = plain_rmsnorm() if way == "plain" else contextlib.nullcontext()
        routing = (routing_choices(choices, replay=way == "plain") if pin_routing
                   else contextlib.nullcontext())
        with norm, routing:
            art = build_train_step(cfg, plan, "cuda", shape, attn_impl=impl,
                                   adam=AdamConfig(lr=3e-4, use_fused_kernel=fused))
            if init is None:
                init = clone(art.init(torch.Generator(device="cuda").manual_seed(0))["params"])
            state = art.place_state(clone(init))
            grads, _ = art.grad_fn(state, batch)
            paths = leaf_paths(grads)
            grads = tree_leaves(grads)  # widened leaf by leaf for the cosines
            K.reset_launch_counts()
            losses, norms = [], []
            for _ in range(steps):
                state, metrics = art.fn(state, batch)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
            torch.cuda.synchronize()
        out[way] = {"loss": losses[0], "grad_norm": norms[0], "grads": grads,
                    "losses": losses, "launches": dict(K.launch_counts())}
        del state, art
        torch.cuda.empty_cache()
    k, p = out["kernels"], out["plain"]
    cos = [torch.nn.functional.cosine_similarity(a.flatten().float(), b.flatten().float(),
                                                 dim=0).item()
           for a, b in zip(k["grads"], p["grads"])]
    res = {"loss_kernels": k["loss"], "loss_plain": p["loss"],
           "grad_norm_kernels": k["grad_norm"], "grad_norm_plain": p["grad_norm"],
           "grad_norm_rel_diff": abs(k["grad_norm"] - p["grad_norm"]) / p["grad_norm"],
           "min_grad_cosine": min(cos), "leaves": len(cos), "launches": k["launches"],
           "lowest_cosines": sorted(zip(cos, paths))[:4]}
    if steps > 1:
        res.update(losses_kernels=k["losses"], losses_plain=p["losses"])
    return res


def phase_train_compare() -> None:
    """One step of 2-layer full-width mistral-7b, kernels vs plain path: all
    resident, then under a compress8 / swap plan with the head's weights in
    pinned host memory."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import MemoryPlan, fully_resident_plan

    cfg = dataclasses.replace(get_config("mistral-7b"), num_layers=2)
    shape = ShapeConfig("compare", TRAIN_SEQ, 1, "train")
    cases = (("resident", fully_resident_plan(4, 2)),
             ("compress8_swap_host_head",
              MemoryPlan(4, 2, n_persist=3, n_host=1, host_params=True, n_buffer=1,
                         act_policies=("compress8", "swap"))))
    for name, plan in cases:
        t0 = time.perf_counter()
        r = compare_step(cfg, shape, plan)
        emit("train_compare", case=name, plan=plan.describe(), arch=cfg.name,
             layers=cfg.num_layers, seq=TRAIN_SEQ, batch=1, **r,
             tol={"loss": LOSS_TOL, "grad_norm_rel": NORM_RTOL, "cosine": GRAD_COSINE},
             seconds=time.perf_counter() - t0)
        assert abs(r["loss_kernels"] - r["loss_plain"]) <= LOSS_TOL, (name, r)
        assert r["grad_norm_rel_diff"] <= NORM_RTOL, (name, r)
        assert r["min_grad_cosine"] >= GRAD_COSINE, (name, r)
    torch.cuda.empty_cache()


def adam_launches(state) -> int:
    """Fused-Adam launches of one step: one a parameter leaf, and one a
    segment (``kernels/fused_adam.segments``) for a leaf whose weights or
    optimizer states lie in pinned host memory (the copy-engine pipeline)."""
    from repro_torch.kernels.fused_adam import segments
    from repro_torch.optim.adam import tree_leaves

    trees = [tree_leaves(state["params"])] + [tree_leaves(state["opt"][k])
                                              for k in ("master", "m", "v")]
    return sum(len(segments(ts[0].numel())) if any(t.device.type == "cpu" for t in ts) else 1
               for ts in zip(*trees))


def layer_norms(cfg, layer: int) -> int:
    """RMSNorm launches of one layer's forward: norm1, the Mamba-2 mixer's
    gated norm, norm2 before an MLP or MoE; none in a LayerNorm model."""
    if cfg.norm != "rmsnorm":
        return 0
    return (1 + (cfg.mixer_at(layer) != "attention")
            + (cfg.moe_at(layer) or cfg.d_ff > 0))


def kept_sites(cfg) -> int:
    """Save sites of a layer that the backward reads: norm1's output, the
    mixer's and, in an encoder-decoder's decoder, the cross-attention's."""
    return 2 + (cfg.kind == "encdec")


def layer_sites(cfg, layer: int) -> int:
    """Save sites of one layer (``models/model.apply_position``): the kept
    ones (``kept_sites``), and the MLP's or MoE's output if it has one."""
    return kept_sites(cfg) + (cfg.moe_at(layer) or cfg.d_ff > 0)


def expected_train_launches(cfg, art, steps: int, adam_per_step: int) -> dict[str, int]:
    """Launches the plan implies: per microbatch a forward of every layer, a
    second forward (the replay) of every layer that does not keep its
    activations (checkpoint, swap, compress8, compress16) and a backward of
    every layer; the flash kernels in the attention layers (an
    encoder-decoder's decoder layer attends twice, itself and the encoder's
    output, and each encoder layer is always recomputed); the RMSNorms of
    each layer forward (``layer_norms``) plus the final one (their backward
    is plain); the quantizer at every save site of a compress8 layer in the
    forward, never in the replay; ``adam_per_step`` Adam launches per step
    (``adam_launches``)."""
    from repro_torch.models.model import superblock_period

    policies = [r.act_policy for r in art.runs
                for _ in range(r.length * superblock_period(cfg))]  # by layer
    layers = range(cfg.num_layers)
    per_layer = 1 + (cfg.kind == "encdec")  # self- and cross-attention
    attn = [per_layer * (cfg.mixer_at(i) == "attention") for i in layers]
    enc = cfg.encoder_layers if cfg.kind == "encdec" else 0
    recomputed = [p != "none" for p in policies]
    mbs = steps * art.plan.microbatch
    return {"flash_attention": mbs * (sum(a * (1 + r) for a, r in zip(attn, recomputed))
                                      + 2 * enc),
            "flash_attention_bwd": mbs * (sum(attn) + enc),
            "rmsnorm": mbs * ((cfg.norm == "rmsnorm") + sum(
                layer_norms(cfg, i) * (1 + r) for i, r in zip(layers, recomputed))),
            "fused_adam": steps * adam_per_step,
            "fused_quantize_ef": mbs * sum(layer_sites(cfg, i) for i, p in zip(layers, policies)
                                           if p == "compress8")}


def bias_bytes_per_block(cfg) -> int:
    """Bytes of one superblock's LayerNorm biases: the only weights no
    backward reads (an add's gradient needs neither operand)."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    out = []

    def walk(tree, name=""):
        if isinstance(tree, L.ParamDef):
            if name == "bias":
                out.append(math.prod(tree.shape[1:]) * L.torch_dtype(tree.dtype).itemsize)
            return
        for k, v in tree.items():
            walk(v, k)

    walk(M.param_defs(cfg)["blocks"])
    return sum(out)


def expected_host_traffic(cfg, plan, shape, steps: int) -> dict[str, int]:
    """The ``train.*`` counters the plan implies, from the chunk inventory:
    each host-resident chunk's weights fetched once per microbatch, an
    unbuffered block's once more for its backward (all of them for a
    recomputed block, whose replay runs its forward again; for a block that
    keeps its activations, those its backward reads: all but the LayerNorm
    biases, ``bias_bytes_per_block``); the kept site tensors
    (``kept_sites``) swapped out and back per swap layer and microbatch;
    the quantizer at each save site (``layer_sites``) of a compress8 layer,
    per microbatch. A site holds every position: the tokens and, before
    them, a vision-language model's patches."""
    from repro_torch.core.chunks import chunk_inventory

    mbs = steps * plan.microbatch
    policies = plan.block_policies()
    host = [c for c in chunk_inventory(cfg)
            if plan.host_params and plan.chunk_placement(c.index) == "host"]
    fetched = sum(c.param_bytes for c in host) + sum(
        c.param_bytes - (bias_bytes_per_block(cfg) if policies[c.block_index] == "none" else 0)
        for c in host if c.is_block and not plan.chunk_buffered(c.index))
    positions = shape.seq_len + patch_count(cfg, shape.seq_len)
    site = shape.global_batch // plan.microbatch * positions * cfg.d_model * 2  # bf16
    swapped = kept_sites(cfg) * site * policies.count("swap")
    return {"train.weight_fetch_bytes": mbs * fetched, "train.act_swap_out_bytes": mbs * swapped,
            "train.act_swap_in_bytes": mbs * swapped,
            "train.act_quantize_launches": mbs * sum(
                layer_sites(cfg, i) for i, p in enumerate(policies) if p == "compress8")}


def train_setup():
    """(config, shape, plan) of the ``train`` phase: 8-layer full-width
    mistral-7b at S 4096, B 2 in two microbatches, two host chunks."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import MemoryPlan

    cfg = dataclasses.replace(get_config("mistral-7b"), num_layers=8)
    plan = MemoryPlan(n_chunks=10, n_blocks=8, n_persist=4, n_host=2, n_checkpoint=4,
                      microbatch=2, host_optimizer=True, host_params=False)
    return cfg, ShapeConfig("train", TRAIN_SEQ, 2, "train"), plan


def phase_train() -> dict[str, int]:
    """4 steps of 8-layer full-width mistral-7b through train_loop."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.core.chunks import chunk_inventory, total_param_count
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.optim.adam import AdamConfig, tree_leaves
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.step_builder import build_train_step

    steps = 4
    cfg, shape, plan = train_setup()
    batch = shape.global_batch
    chunks = chunk_inventory(cfg)
    assert len(chunks) == plan.n_chunks
    art = build_train_step(cfg, plan, "cuda", shape, adam=AdamConfig(lr=3e-4))
    pipe = SyntheticTokenPipeline(cfg, shape, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_loop(art, pipe, None, LoopConfig(total_steps=steps, log_every=1),
                     generator=torch.Generator(device="cuda").manual_seed(0),
                     log=lambda line: print(line, flush=True))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: K.launch_counts()[k] for k in TRAINING_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    state = res.state
    expected = expected_train_launches(cfg, art, steps, adam_launches(state))

    # where each optimizer state lies: pinned host for the host chunks
    host_runs = [r.placement == "host" for r in art.runs]
    pinned_bytes, misplaced = 0, []
    for key in ("master", "m", "v"):
        tree = state["opt"][key]
        for name in ("embed", "final_norm", "head", "runs"):
            subs = tree[name] if name == "runs" else [tree[name]]
            chunk = 0 if name == "embed" else plan.n_chunks - 1
            hosts = host_runs if name == "runs" else [plan.chunk_placement(chunk) == "host"]
            for sub, on_host in zip(subs, hosts):
                for t in tree_leaves(sub):
                    if on_host:
                        ok = t.device.type == "cpu" and t.is_pinned()
                        pinned_bytes += t.numel() * t.element_size()
                    else:
                        ok = t.device.type == "cuda"
                    if not ok:
                        misplaced.append(f"{key}/{name}")
    tokens = batch * TRAIN_SEQ
    n_params = total_param_count(chunks)
    flops = model_flops(cfg, tokens)
    med = statistics.median(res.step_times)
    emit("train", arch=cfg.name, layers=cfg.num_layers, params=n_params, seq=TRAIN_SEQ,
         global_batch=batch, plan=plan.describe(), runs=[dataclasses.asdict(r) for r in art.runs],
         losses=res.losses, step_times_s=res.step_times, median_step_s=med,
         tokens_per_s=tokens / med, peak_device_bytes=peak, pinned_host_bytes=pinned_bytes,
         model_flops_per_step=flops, mfu=flops / med / BF16_FLOP_PER_S,
         launches=launches, expected_launches=expected, seconds=seconds)
    assert len(res.losses) == steps and all(math.isfinite(x) for x in res.losses), res.losses
    assert abs(res.losses[0] - math.log(cfg.vocab_size)) <= FIRST_LOSS_BAND, res.losses[0]
    assert not misplaced, f"optimizer states in the wrong place: {sorted(set(misplaced))}"
    assert pinned_bytes > 0
    assert launches == expected, f"launches {launches} != the plan's {expected}"
    del res, state, art
    torch.cuda.empty_cache()
    return launches, {"case": "train", "cfg": cfg, "shape": shape, "plan": plan,
                      "median_step_s": med, "peak_device_bytes": peak}


def host_allocator_bytes() -> int | None:
    """Bytes PyTorch's caching host allocator holds (pinned blocks in use
    and cached), where this torch reports them."""
    import torch

    stats = getattr(torch.cuda.memory, "host_memory_stats", None)
    return None if stats is None else stats().get("allocated_bytes.current")


def pinned_state_bytes(state) -> int:
    from repro_torch.optim.adam import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(state["params"])
               + tree_leaves({k: state["opt"][k] for k in ("master", "m", "v")})
               if t.device.type == "cpu" and t.is_pinned())


def active_matmul_params(cfg) -> int:
    """Parameters a token's forward multiplies by: all but the embedding (a
    lookup) and, in each MoE layer, the routed experts it does not choose
    (``(E - top_k) / E`` of them). The dense dispatch and combine einsums of
    ``models/moe.py``, and the capacity rows no token fills, are work the
    model's FLOPs do not count."""
    from repro_torch.core.chunks import chunk_inventory, total_param_count
    from repro_torch.models.moe import moe_defs

    n = total_param_count(chunk_inventory(cfg)) - cfg.vocab_size * cfg.d_model
    if cfg.moe is not None:
        defs = moe_defs(cfg)
        routed = sum(math.prod(defs[k].shape) for k in ("w1", "w2", "w3") if k in defs)
        unchosen = routed * (cfg.moe.num_experts - cfg.moe.top_k) // cfg.moe.num_experts
        n -= unchosen * sum(cfg.moe_at(i) for i in range(cfg.num_layers))
    return n


def patch_count(cfg, seq: int) -> int:
    """Image patches a sequence of ``seq`` tokens carries (the pipeline's
    ``min(1024, S)`` for the vision frontend, else none)."""
    return min(1024, seq) if cfg.frontend == "vision_patches" else 0


def model_flops(cfg, tokens: int, seq: int = TRAIN_SEQ) -> int:
    """6 x active matmul parameters (``active_matmul_params``) x tokens plus
    the attention products (x3 for the backward) of one step, in the
    attention layers (a Mamba-2 layer has none): causal pairs in a decoder's
    self-attention; in an encoder-decoder also S^2 pairs in each encoder
    layer and S x S_src in each cross-attention (its frames are as many as
    its tokens). A vision-language model's patches are P more positions
    through every layer and its attention (S + P causal pairs), and none
    through the head."""
    rows = tokens // seq
    n_matmul = active_matmul_params(cfg)
    n_head = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    pos = seq + patch_count(cfg, seq)
    n_attn = sum(cfg.mixer_at(i) == "attention" for i in range(cfg.num_layers))
    pairs = attended_pairs(pos, cfg.sliding_window) * n_attn
    if cfg.kind == "encdec":
        pairs += seq * seq * (cfg.encoder_layers + n_attn)
    attn = 3 * 4 * cfg.resolved_head_dim * cfg.num_heads * pairs * rows
    return 6 * ((n_matmul - n_head) * pos + n_head * seq) * rows + attn


KERNEL_KINDS = (  # device work of a training step, by kernel name, first match
    ("flash_forward", ("flash_fwd_",)),
    ("flash_backward", ("flash_delta_kernel", "flash_dkdv_", "flash_dq_")),
    ("fused_adam", ("fused_adam_kernel",)),
    ("fused_quantize_ef", QUANT_KERNELS),
    ("rmsnorm", ("rmsnorm_kernel",)),
    ("collective", ("nccl",)),  # the gradient sync's collectives (dist_sync)
    # fp32 GEMMs outside the tensor cores: the MoE's dense dispatch and
    # combine einsums (models/moe.py) and its fp32 router product, the
    # Mamba-2 SSD's einsums (models/mamba2.py)
    ("gemm_fp32", ("sgemm", "f32f32_f32f32", "gemv", "nvjet_sss")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
    ("copy_to_device", ("Memcpy HtoD",)),
    ("copy_to_host", ("Memcpy DtoH",)),
    # PyTorch's own elementwise, reduction, scan and concatenation kernels
    ("elementwise", ("elementwise", "reduce_kernel", "CatArray", "scan", "Scan")),
)
# annotations (spans on the device track, not work): the step, the
# optimizer's update (optim/adam.py), the SSD's chunk loop (models/mamba2.py)
SPANS = ("train_step", "adam_update", "ssd_chunk_scan")


def _merge(spans) -> list[list[float]]:
    out = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _inside(start: float, end: float, merged, starts) -> float:
    """The part of [start, end] inside the merged spans."""
    import bisect

    i = max(bisect.bisect_right(starts, start) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < end:
        total += max(0.0, min(end, merged[i][1]) - max(start, merged[i][0]))
        i += 1
    return total


def profile_step(art, state, batch) -> dict:
    """One more step under ``torch.profiler``: device time by kind of
    kernel (``KERNEL_KINDS``, the rest as ``other``), and the share of the
    step's wall time in which no device work ran (the union of the device
    intervals against the step's span). The profiler's own cost inflates
    the wall time, so the idle share is an upper bound. The optimizer's
    span on the device (``adam_update``: the device track of the
    optimizer's annotation, from its first copy or kernel to its last
    write-back) is reported beside the kinds, with the device time by kind
    inside it: the Adam pipeline's copies are counted under the copy kinds."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("train_step"):
            state, metrics = art.fn(state, batch)
            float(metrics["loss"])
            torch.cuda.synchronize()
    events = prof.events()
    span = next(e for e in events if e.name == "train_step").time_range
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    # the device track also carries the annotations: spans, not work. The
    # optimizer's shows once per stream it used: its span is their union
    adam = [e.time_range for e in on_device if e.name == "adam_update"]
    adam_span = (min(a.start for a in adam), max(a.end for a in adam)) if adam else None
    # the SSD chunk loop's forward (its replays too): kernels inside its spans
    scan = _merge((e.time_range.start, e.time_range.end) for e in on_device
                  if e.name == "ssd_chunk_scan")
    scan_starts = [a for a, _ in scan]
    scan_ms, scan_kernels = 0.0, 0
    device = [e for e in on_device if e.name not in SPANS]
    kinds = [k for k, _ in KERNEL_KINDS] + ["other"]
    by_kind, in_adam = dict.fromkeys(kinds, 0.0), dict.fromkeys(kinds, 0.0)
    others: dict[str, list] = {}
    intervals = []
    for e in device:
        start, end = max(e.time_range.start, span.start), min(e.time_range.end, span.end)
        if end <= start:
            continue
        intervals.append((start, end))
        kind = next((k for k, keys in KERNEL_KINDS if any(x in e.name for x in keys)), "other")
        by_kind[kind] += (end - start) / 1e3
        if scan:
            part = _inside(start, end, scan, scan_starts)
            scan_ms += part / 1e3
            scan_kernels += part > 0
        if adam_span:
            in_adam[kind] += max(0, min(end, adam_span[1]) - max(start, adam_span[0])) / 1e3
        if kind in ("other", "gemm", "gemm_fp32", "elementwise"):
            o = others.setdefault((kind, e.name[:100]), [0, 0.0])
            o[0] += 1
            o[1] += (end - start) / 1e3
    top = {k: sorted(((n, c, ms) for (kk, n), (c, ms) in others.items() if kk == k),
                     key=lambda r: -r[2])[:8]
           for k in ("other", "gemm", "gemm_fp32", "elementwise")}
    busy, last = 0.0, span.start
    for start, end in sorted(intervals):
        busy += max(0.0, end - max(start, last))
        last = max(last, end)
    wall_ms = (span.end - span.start) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3, "device_ms_by_kind": by_kind,
            "main_stream_host_reads": main_stream_host_reads(prof, span, wall_ms),
            "adam_update_span_ms": (adam_span[1] - adam_span[0]) / 1e3 if adam_span else None,
            "adam_update_ms_by_kind": in_adam if adam_span else None,
            "ssd_chunk_loop_fwd_ms": scan_ms if scan else None,
            "ssd_chunk_loop_fwd_kernels": scan_kernels if scan else None,
            **{f"{k}_top": [{"name": n, "calls": c, "ms": ms} for n, c, ms in rows]
               for k, rows in top.items()},
            "device_events": len(device),
            "idle_share_at_most": 1.0 - busy / 1e3 / wall_ms if device else None}


def main_stream_host_reads(prof, span, wall_ms: float) -> dict:
    """What the step's host reads on the main stream cost the card. The
    forward's weight fetches run ahead on a side stream, and the Adam
    pipeline has streams of its own; the backward queues its copies to the
    device (weights fetched again, swapped activations back) on the main
    stream, where the kernels that need them wait. The main stream is the
    one with the most GEMM time. Reported: those copies' count and time,
    and the part of it in which no kernel ran on any stream (``idle_ms``),
    the card's idle time that prefetching them on a side stream could at
    most win back, also as a share of the step (``idle_share_of_step``)."""
    import torch

    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()  # the events' time_range is relative to it, in us
    lo, hi = t0 + span.start * 1e3, t0 + span.end * 1e3
    gemm, copies, kernels = {}, [], []
    for e in results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start, end = max(e.start_ns(), lo), min(e.end_ns(), hi)
        if end <= start:
            continue
        name, stream = e.name(), e.device_resource_id()
        if "Memcpy HtoD" in name:
            copies.append((stream, start, end))
        elif "Memcpy" not in name and "Memset" not in name and name not in SPANS:
            kernels.append((start, end))
            if any(x in name for x in dict(KERNEL_KINDS)["gemm"]):
                gemm[stream] = gemm.get(stream, 0) + end - start
    if not gemm:
        return {"main_stream": None}
    main = max(gemm, key=gemm.get)
    merged = []
    for start, end in sorted(kernels):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    mine = [(s, e) for st, s, e in copies if st == main]
    idle = sum((e - s) - sum(max(0, min(e, k1) - max(s, k0)) for k0, k1 in merged)
               for s, e in mine) / 1e6
    return {"main_stream": main, "copies": len(mine),
            "copy_ms": sum(e - s for s, e in mine) / 1e6, "idle_ms": idle,
            "idle_share_of_step": idle / wall_ms if wall_ms else None}


def policy_run(cfg, shape, plan, steps: int, profile: bool = False, drift=None,
               warmup: int = 0) -> dict:
    """``steps`` steps of ``plan`` through build_train_step and train_loop,
    with the launch counts zeroed just before: losses, step times (the
    median over the steps after ``warmup``), device and pinned bytes, the
    ``train.*`` counters and the launches; ``drift``: an
    ``obs.DriftMonitor`` the loop feeds; with ``profile``, then one more
    step under the profiler."""
    import torch

    from repro_torch import kernels as K
    from repro_torch import obs
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.step_builder import build_train_step

    tel = obs.Telemetry(trace=False)
    art = build_train_step(cfg, plan, "cuda", shape, adam=AdamConfig(lr=3e-4), telemetry=tel)
    pipe = SyntheticTokenPipeline(cfg, shape, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_loop(art, pipe, None, LoopConfig(total_steps=steps, log_every=1),
                     generator=torch.Generator(device="cuda").manual_seed(0),
                     log=lambda line: print(line, flush=True), drift=drift)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: K.launch_counts()[k] for k in TRAINING_KERNELS}
    snap = {k: v["value"] for k, v in tel.registry.snapshot().items() if "value" in v}
    out = {"plan": plan.describe(), "runs": [dataclasses.asdict(r) for r in art.runs],
           "losses": res.losses, "ces": res.ces,
           "aux_losses": [a - b for a, b in zip(res.losses, res.ces)],
           "step_times_s": res.step_times,
           "median_step_s": statistics.median(res.step_times[warmup:]),
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "act_bytes": snap["train.act_bytes"],
           "pinned_state_bytes": pinned_state_bytes(res.state),
           "host_allocator_bytes": host_allocator_bytes(),
           # swapped sites wait in pinned memory from the forward to the backward
           "pinned_act_bytes": snap["train.act_swap_out_bytes"] / (steps * plan.microbatch),
           "counters": {k: v for k, v in snap.items() if k != "train.act_bytes"},
           "expected_counters": expected_host_traffic(cfg, plan, shape, steps),
           "launches": launches,
           "expected_launches": expected_train_launches(cfg, art, steps,
                                                        adam_launches(res.state)),
           "seconds": seconds}
    if profile:
        out["profile"] = profile_step(art, res.state, pipe.next_sync())
    del res, art
    gc.collect()
    torch.cuda.empty_cache()
    return out


# block 6 (chunk 7, unbuffered) keeps its activations: its weights are
# re-fetched for the backward through the saved-tensor hooks; block 7
# (chunk 8, buffered) keeps its fetched weights for its replay
MIXED_POLICIES = ("checkpoint", "compress8", "compress16", "swap", "none", "compress8", "none",
                  "compress8")


def _relayout(params, runs):
    """A copy of a tree with stacked ``blocks`` as the state tree of a run
    layout (a copy: the step updates its state in place)."""
    import torch

    def sl(tree, start=0, length=None):
        if isinstance(tree, torch.Tensor):
            return (tree if length is None else tree[start:start + length]).clone()
        return {k: sl(v, start, length) for k, v in tree.items()}

    out = {k: sl(v) for k, v in params.items() if k != "blocks"}
    out["runs"] = [sl(params["blocks"], r.start, r.length) for r in runs]
    return out


def host_vs_device(cfg, shape, plan, steps: int) -> dict:
    """``steps`` steps of ``plan`` and of its act policies with every chunk
    on the device, from one init and one batch stream: the losses, and how
    many final fp32 master leaves differ, with the largest difference."""
    import torch

    from repro_torch.core.plan import MemoryPlan
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.models import model as M
    from repro_torch.optim.adam import AdamConfig, tree_leaves
    from repro_torch.train.step_builder import build_train_step

    device_plan = MemoryPlan(n_chunks=plan.n_chunks, n_blocks=plan.n_blocks,
                             n_persist=plan.n_chunks, microbatch=plan.microbatch,
                             act_policies=plan.act_policies)
    init = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    out = {}
    for name, p in (("device", device_plan), ("host", plan)):
        art = build_train_step(cfg, p, "cuda", shape, adam=AdamConfig(lr=3e-4))
        state = art.place_state(_relayout(init, art.runs))
        pipe = SyntheticTokenPipeline(cfg, shape, seed=0, device="cuda")
        losses = [float(art.fn(state, pipe.next_sync())[1]["loss"]) for _ in range(steps)]
        torch.cuda.synchronize()
        master = state["opt"]["master"]  # the runs' leaves joined back into blocks
        blocks = [torch.cat([t.cpu() for t in ts])
                  for ts in zip(*(tree_leaves(r) for r in master["runs"]))]
        rest = tree_leaves({k: v for k, v in master.items() if k != "runs"})
        out[name] = (losses, blocks + [t.cpu() for t in rest])
        del state, art, master
        gc.collect()
        torch.cuda.empty_cache()
    del init
    (dev_losses, dev_m), (losses, m) = out["device"], out["host"]
    diffs = [float((a - b).abs().max()) for a, b in zip(m, dev_m) if not torch.equal(a, b)]
    return {"plan": plan.describe(), "device_plan": device_plan.describe(), "steps": steps,
            "losses_host": losses, "losses_device": dev_losses,
            "master_leaves": len(m), "master_leaves_differing": len(diffs),
            "master_max_abs_diff": max(diffs, default=0.0)}


def check_run(name: str, run: dict) -> None:
    assert all(math.isfinite(x) for x in run["losses"]), (name, run["losses"])
    assert run["launches"] == run["expected_launches"], (
        f"{name}: launches {run['launches']} != the plan's {run['expected_launches']}")
    for key, want in run["expected_counters"].items():
        assert run["counters"][key] == want, f"{name}: {key} {run['counters'][key]} != {want}"


def phase_train_policies() -> dict[str, int]:
    """8-layer full-width mistral-7b under each uniform act policy (2 steps,
    all chunks on the device), then a mixed plan with every policy and host
    weights (4 steps)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.chunks import chunk_inventory
    from repro_torch.core.plan import MemoryPlan

    cfg = dataclasses.replace(get_config("mistral-7b"), num_layers=8)
    shape = ShapeConfig("train", TRAIN_SEQ, 2, "train")
    uniform = {}
    for pol in ("none", "compress16", "compress8", "checkpoint", "swap"):
        plan = MemoryPlan(n_chunks=10, n_blocks=8, n_persist=10, microbatch=2,
                          act_policies=(pol,) * 8)
        run = policy_run(cfg, shape, plan, steps=2)
        emit("train_policies", case=f"uniform_{pol}", arch=cfg.name, layers=cfg.num_layers,
             seq=TRAIN_SEQ, global_batch=shape.global_batch, **run)
        check_run(pol, run)
        uniform[pol] = run["act_bytes"]
    order = ("none", "compress16", "compress8", "checkpoint")
    assert all(uniform[a] > uniform[b] for a, b in zip(order, order[1:])), (
        f"act_bytes not ordered {order}: {uniform}")

    plan = MemoryPlan(n_chunks=10, n_blocks=8, n_persist=4, n_host=3, host_params=True,
                      n_buffer=2, microbatch=2, act_policies=MIXED_POLICIES)
    steps = 4
    run = policy_run(cfg, shape, plan, steps=steps, profile=True)
    tokens = shape.global_batch * TRAIN_SEQ
    flops = model_flops(cfg, tokens)
    c = run["counters"]
    host_params = sum(ci.param_count for ci in chunk_inventory(cfg)
                      if plan.chunk_placement(ci.index) == "host")
    # Adam copies fp32 master, m, v of each host chunk in over the link and
    # back out with the new bf16 weights (the copy-engine pipeline)
    adam_read, adam_write = 12 * host_params * steps, 14 * host_params * steps
    emit("train_policies", case="mixed", arch=cfg.name, layers=cfg.num_layers, seq=TRAIN_SEQ,
         global_batch=shape.global_batch, **run, tokens_per_s=tokens / run["median_step_s"],
         model_flops_per_step=flops, mfu=flops / run["median_step_s"] / BF16_FLOP_PER_S,
         host_link_bytes={"to_device": c["train.weight_fetch_bytes"]
                          + c["train.act_swap_in_bytes"] + adam_read,
                          "to_host": c["train.act_swap_out_bytes"] + adam_write,
                          "of": f"{steps} steps, counted from the counters and the plan"})
    check_run("mixed", run)
    assert len(run["losses"]) == steps
    assert abs(run["losses"][0] - math.log(cfg.vocab_size)) <= FIRST_LOSS_BAND, run["losses"]
    assert run["pinned_state_bytes"] > 0

    t0 = time.perf_counter()
    cmp = host_vs_device(cfg, shape, plan, steps=2)
    emit("train_policies", case="mixed_vs_device", arch=cfg.name, layers=cfg.num_layers, **cmp,
         tol="bitwise", seconds=time.perf_counter() - t0)
    assert cmp["losses_host"] == cmp["losses_device"], cmp
    assert cmp["master_leaves_differing"] == 0, cmp
    return run["launches"], {"case": "mixed", "cfg": cfg, "shape": shape, "plan": plan,
                             "median_step_s": run["median_step_s"],
                             "peak_device_bytes": run["peak_device_bytes"]}


# ---------------------------------------------------------------------------
# The planner slice
# ---------------------------------------------------------------------------
# The JAX reference's profile of one mistral-7b superblock at B 1, S 4096
# (src/repro/core/profiler.py on jax 0.9.0, the CPU; tests/test_torch_planner.py
# holds these numbers to it), printed beside the port's own.
REFERENCE_BLOCK_PROFILE = dict(flops_fwd=2064647659909.0, hbm_bytes_fwd=40396927736,
                               act_residual_bytes=1636894208, boundary_bytes=33554432,
                               peak_transient_bytes=1749032976)
PLAN_STEPS, PLAN_WARMUP = 3, 1  # one warm-up step, then two timed ones
PLAN_ATTEMPTS = 3  # searches at a lowered capacity after an out-of-memory
# host memory left to the process besides the pinned states; it also covers
# a machine that caps a process some GiB below MemTotal
HOST_MARGIN = 8 << 30


def host_memory() -> dict:
    """The host's memory: ``free -g``'s lines and /proc/meminfo's total and
    available bytes."""
    free = subprocess.run(["free", "-g"], capture_output=True, text=True, timeout=60).stdout
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":")
            info[key] = int(val.split()[0]) * 1024
    return {"free_g": free.strip().splitlines(), "total_bytes": info["MemTotal"],
            "available_bytes": info["MemAvailable"]}


def plan_pinned_bytes(w, plan) -> int:
    """Pinned host bytes the plan's host chunks take: fp32 master, m and v,
    plus the bf16 weights under host_params."""
    return sum(c.optim_bytes + (c.param_bytes if plan.host_params else 0)
               for c in w.chunks if plan.chunk_placement(c.index) == "host")


def pinned_alloc_bytes(cfg, plan) -> int:
    """Host bytes the plan's pinned states take from PyTorch's caching host
    allocator, which rounds each allocation up to a power of two: per leaf
    of a host chunk (a run's leaves stacked over its layers), fp32 master,
    m and v, and the weights under host_params, each rounded."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.train.step_builder import plan_runs

    defs = M.param_defs(cfg)
    leaves = []  # (elements, weight bytes an element)

    def collect(tree, length=None):
        L.map_defs(lambda d: leaves.append((
            math.prod(d.shape if length is None else (length,) + d.shape[1:]),
            L.torch_dtype(d.dtype).itemsize)), tree)

    if plan.chunk_placement(0) == "host":
        collect({k: defs[k] for k in ("embed", "encoder") if k in defs})
    if plan.chunk_placement(plan.n_chunks - 1) == "host":
        collect({k: defs[k] for k in ("final_norm", "head") if k in defs})
    for run in plan_runs(plan, M.num_repeats(cfg)):
        if run.placement == "host":
            collect(defs["blocks"], run.length)
    up = lambda n: 1 << (n - 1).bit_length()  # noqa: E731
    return sum(3 * up(4 * n) + (up(b * n) if plan.host_params else 0) for n, b in leaves)


def modeled(w, plan) -> dict:
    from repro_torch.core.cost_model import estimate_memory, estimate_runtime

    rt, mem = estimate_runtime(w, plan), estimate_memory(w, plan)
    return {"t_iteration": rt.t_iteration, "t_fwd": rt.t_fwd, "t_bwd": rt.t_bwd,
            "t_gpu_optim": rt.t_gpu_optim, "t_cpu_optim": rt.t_cpu_optim,
            "peak_bytes": mem.peak, "memory": {k: v for k, v in vars(mem).items()
                                               if k != "trajectory"}}


def calibration_row(hw, run: dict) -> dict:
    """An earlier phase's plan priced on ``hw`` by the port's cost model,
    beside what that phase measured."""
    from repro_torch.core.cost_model import build_workload
    from repro_torch.core.hardware import ONE_CHIP

    w = build_workload(run["cfg"], run["shape"], ONE_CHIP, hw)
    m = modeled(w, run["plan"])
    return {"case": run["case"], "layers": run["cfg"].num_layers,
            "global_batch": run["shape"].global_batch, "plan": run["plan"].describe(), **m,
            "measured_step_s": run["median_step_s"],
            "measured_peak_bytes": run["peak_device_bytes"],
            "runtime_ratio": m["t_iteration"] / run["median_step_s"],
            "memory_ratio": m["peak_bytes"] / run["peak_device_bytes"]}


def _oom_shortfall(err: Exception, usable: int) -> int:
    """Bytes by which an out-of-memory step outran the card, at least: the
    allocator's bytes at the failure plus the request, less what was free."""
    import re

    import torch

    m = re.search(r"Tried to allocate ([0-9.]+) (GiB|MiB|KiB|B)", str(err))
    unit = {"GiB": 1 << 30, "MiB": 1 << 20, "KiB": 1 << 10, "B": 1}
    asked = int(float(m.group(1)) * unit[m.group(2)]) if m else 0
    stats = torch.cuda.memory_stats()
    return max(stats["reserved_bytes.all.current"] + asked - usable, asked)


class NoPlanTrained(AssertionError):
    """``plan_phase`` trained no plan: the search found none that fits the
    card, or every searched plan ran out of memory."""

    def __init__(self, attempts: list):
        super().__init__(f"no plan trained within {PLAN_ATTEMPTS} searches: {attempts}")
        self.attempts = attempts


def batch_draw_seconds(cfg, shape) -> float:
    """Host seconds to draw one batch of ``shape`` and place it on the card
    (an encoder-decoder's carries its fp32 frames, a vision-language
    model's its patches); the training loop draws it before it starts a
    step's clock."""
    import torch

    from repro_torch.data.pipeline import SyntheticTokenPipeline

    pipe = SyntheticTokenPipeline(cfg, shape, seed=0, device="cuda")
    t0 = time.perf_counter()
    batch = pipe.next_sync()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del batch
    return seconds


def plan_phase(cfg, hw, phase: str, reference_profile: dict | None = None,
               seq: int = TRAIN_SEQ) -> dict:
    """ProTrain's planner on the card: the port's profile of a full-width
    superblock of ``cfg``, the search for ``seq`` and global batch 1 on
    ``hw`` (this card's spec), and 1 + 2 steps under the searched plan at
    full width and the deepest stack whose pinned states fit the host, each
    number beside the cost model's; then one profiled step.
    ``reference_profile``: the JAX reference's block profile, searched on
    too and printed beside the port's."""
    import torch

    from repro_torch import obs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.autotuner import search
    from repro_torch.core.chunks import chunk_inventory
    from repro_torch.core.cost_model import build_workload
    from repro_torch.core.hardware import ONE_CHIP
    from repro_torch.core.profiler import BlockProfile
    from repro_torch.models.model import superblock_period

    gc.collect()
    torch.cuda.empty_cache()
    # new device segments grow in place from here on: the transients of a
    # step near the card's capacity and the blocks that side-stream copies
    # hold until their stream passes otherwise leave memory reserved between
    # allocations (8.9 GiB at mistral-7b's searched plan, 12 GiB at
    # qwen2-moe's, each failing on the H100)
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    usable, total = torch.cuda.mem_get_info()
    host = host_memory()
    shape = ShapeConfig("plan", seq, 1, "train")
    t0 = time.perf_counter()
    w = build_workload(cfg, shape, ONE_CHIP, hw)
    profile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = search(w, compress="off", sync="xla")
    search_s = time.perf_counter() - t0
    beside = {}
    if reference_profile is not None:
        ref_w = dataclasses.replace(w, block=BlockProfile(**reference_profile))
        ref_res = search(ref_w, compress="off", sync="xla")
        beside = {"reference_profile_plan": ref_res.plan.describe(),
                  "reference_profile_modeled": modeled(ref_w, ref_res.plan)}
    emit(f"{phase}_search", arch=cfg.name, layers=cfg.num_layers, seq=seq,
         global_batch=1, hw={k: v for k, v in dataclasses.asdict(hw).items()},
         card_total_bytes=total, card_free_bytes_at_start=usable, host=host,
         allocator="expandable_segments:True",
         profile={"port": dataclasses.asdict(w.block), "reference": reference_profile},
         profile_s=profile_s, plan=res.plan.describe(), feasible=res.feasible,
         evaluated=res.evaluated, search_s=search_s, search_seconds=res.search_seconds,
         modeled=modeled(w, res.plan), pinned_bytes=plan_pinned_bytes(w, res.plan), **beside)
    if not res.feasible:  # no plan to attempt: the search's pick outruns the card's model
        raise NoPlanTrained([{"plan": res.plan.describe(), "error": "the search found no plan "
                              "that fits the card", "modeled": modeled(w, res.plan),
                              "capacity_bytes": w.hw.capacity_bytes()}])

    # host memory: the deepest stack whose pinned states fit, as the host
    # allocator takes them (each allocation rounded up to a power of two)
    budget = host["available_bytes"] - HOST_MARGIN
    cuts = []  # (layers, the plan's pinned bytes, as allocated) of each depth that did not fit
    period = superblock_period(cfg)

    def pinned_fits(layers, plan, w_run) -> bool:
        got = pinned_alloc_bytes(dataclasses.replace(cfg, num_layers=layers), plan)
        if got > budget:
            cuts.append((layers, plan_pinned_bytes(w_run, plan), got))
        return got <= budget

    def fit_host(layers, plan, w_run):
        """The deepest stack from ``layers`` down whose searched plan (on
        ``w_run``'s spec) fits the budget: (layers, plan, workload). Depths
        are bisected in whole superblocks; a shallower stack has the same
        block profile, so only its chunk inventory and its search are made
        anew."""
        if pinned_fits(layers, plan, w_run):
            return layers, plan, w_run
        lo, hi, best = 0, layers // period, None  # hi repeats do not fit
        while hi - lo > 1:
            mid = (lo + hi) // 2
            mid_cfg = dataclasses.replace(cfg, num_layers=mid * period)
            w_mid = dataclasses.replace(w_run, cfg=mid_cfg, chunks=chunk_inventory(mid_cfg))
            plan_mid = search(w_mid, compress="off", sync="xla").plan
            if pinned_fits(mid * period, plan_mid, w_mid):
                lo, best = mid, (mid * period, plan_mid, w_mid)
            else:
                hi = mid
        assert best is not None, "no depth's pinned states fit the host"
        return best

    layers, plan, w_run = fit_host(cfg.num_layers, res.plan, w)

    attempts = []
    for _ in range(PLAN_ATTEMPTS):
        run_cfg = dataclasses.replace(cfg, num_layers=layers)
        drift = obs.DriftMonitor(w_run, plan, window=PLAN_STEPS - PLAN_WARMUP)
        try:
            run = policy_run(run_cfg, shape, plan, steps=PLAN_STEPS, drift=drift,
                             warmup=PLAN_WARMUP, profile=True)
            break
        except torch.OutOfMemoryError as err:
            # the searched plan outran the card: lower the capacity the
            # search budgets against by the shortfall the card showed, and
            # search again (the model, its depth and the checks stay)
            short = _oom_shortfall(err, usable)
            frac = w_run.hw.hbm_capacity_fraction - short / w_run.hw.hbm_bytes
            attempts.append({"plan": plan.describe(), "error": str(err).splitlines()[0],
                             "shortfall_bytes": short, "next_fraction": frac})
            print(f"[plan] out of memory under {plan.describe()}: {attempts[-1]}", flush=True)
            del err
            gc.collect()
            torch.cuda.empty_cache()
            release_pinned_cache()  # the failed attempt's pinned states
            w_run = dataclasses.replace(w_run, hw=dataclasses.replace(
                w_run.hw, hbm_capacity_fraction=frac))
            # fewer persistent chunks put more in pinned memory: fit the host again
            layers, plan, w_run = fit_host(layers, search(w_run, compress="off", sync="xla").plan,
                                           w_run)
    else:
        raise NoPlanTrained(attempts)

    tokens = shape.global_batch * seq
    flops = model_flops(run_cfg, tokens, seq)
    report = drift.report()
    m = modeled(w_run, plan)
    frames = {}
    if cfg.kind == "encdec":
        frames = {"encoder_layers": cfg.encoder_layers, "frames_per_sequence": seq,
                  "batch_draw_s": batch_draw_seconds(run_cfg, shape),
                  "front_chunk": plan.chunk_placement(0),
                  "front_chunk_state_bytes": w_run.chunks[0].param_bytes
                  + w_run.chunks[0].grad_bytes + w_run.chunks[0].optim_bytes}
    if cfg.frontend == "vision_patches":
        frames = {"patches_per_sequence": patch_count(cfg, seq),
                  "profiled_positions": w_run.shape.seq_len,
                  "block_positions": seq + patch_count(cfg, seq),
                  "batch_draw_s": batch_draw_seconds(run_cfg, shape)}
    emit(phase, arch=cfg.name, layers=layers, reduced_depth=layers != cfg.num_layers, **frames,
         depth_cuts={"host_budget_bytes": budget, "pinned_bytes_by_depth": cuts},
         seq=seq, global_batch=shape.global_batch, block_policies=plan.block_policies(),
         hbm_capacity_fraction=w_run.hw.hbm_capacity_fraction, oom_attempts=attempts,
         **run, tokens_per_s=tokens / run["median_step_s"], model_flops_per_step=flops,
         mfu_flops="6 x active matmul parameters x tokens + attention 12 hd Hq pairs an "
                   "attention layer (causal self, S^2 encoder, S x S_src cross)",
         mfu=flops / run["median_step_s"] / BF16_FLOP_PER_S, modeled=m,
         pinned_alloc_bytes_estimate=pinned_alloc_bytes(run_cfg, plan),
         measured_vs_modeled={"step_s": [run["median_step_s"], m["t_iteration"]],
                              "peak_bytes": [run["peak_device_bytes"], m["peak_bytes"]],
                              "pinned_bytes": [run["pinned_state_bytes"],
                                               plan_pinned_bytes(w_run, plan)]},
         drift={"runtime_ratio": report["runtime"]["ratio"],
                "memory_ratio": report["memory"]["ratio"], "ok": report["ok"],
                "band": report["band"]})
    check_run(phase, run)
    assert len(run["losses"]) == PLAN_STEPS
    # the cross-entropy: the loss less the MoE aux loss
    assert abs(run["ces"][0] - math.log(cfg.vocab_size)) <= FIRST_LOSS_BAND, run["ces"]
    assert run["pinned_state_bytes"] == plan_pinned_bytes(w_run, plan), (
        run["pinned_state_bytes"], plan_pinned_bytes(w_run, plan))
    path = ("fused_adam",) + (("rmsnorm",) if cfg.norm == "rmsnorm" else ()) + (
        () if cfg.attention_free else ("flash_attention", "flash_attention_bwd"))
    for name in path:
        assert run["launches"][name] > 0, f"{name} was not launched by the {phase} run"
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": run["launches"], "row": {
        "case": phase, "layers": layers, "global_batch": shape.global_batch,
        "plan": plan.describe(), **m, "measured_step_s": run["median_step_s"],
        "measured_peak_bytes": run["peak_device_bytes"],
        "runtime_ratio": report["runtime"]["ratio"], "memory_ratio": report["memory"]["ratio"]}}


def phase_plan(hw) -> dict:
    """``mistral-7b`` at full depth through ``plan_phase``, beside the
    reference's profile."""
    from repro_torch.configs import get_config

    return plan_phase(get_config("mistral-7b"), hw, "plan", REFERENCE_BLOCK_PROFILE)


def phase_calibration(hw, runs: list[dict], plan_row: dict) -> None:
    """The cost model's H100 calibration: each trained plan's modeled step
    and peak beside the measured ones."""
    rows = [calibration_row(hw, r) for r in runs] + [plan_row]
    emit("calibration", hw=hw.name, host_bw=hw.host_bw, hbm_bytes=hw.hbm_bytes, rows=rows)


# ---------------------------------------------------------------------------
# The MoE family: qwen2-moe-a2.7b
# ---------------------------------------------------------------------------
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_HEADS = (16, 16)  # query over KV heads, hd 128: group 1, no window
MOE_D = 2048
MOE_EXPERT_W1 = (60, 2048, 1408)  # one layer's stacked expert w1
# mamba_serve's depth: a quarter of mamba2-130m's 24 layers, cut so that
# the whole run, the encoder-decoder's phases included, ends near half of
# its time limit (24 layers through PR 20, 12 through PR 27, cut again
# when serve_mesh came; its eager engine, a step a token, takes most of
# the phase)
MAMBA_SERVE_LAYERS = 6
# moe_plan's depth, cut for the run's time once the VLM's phases came (the
# deepest the host can pin is 15 of 24 layers; the pinned states'
# allocation and the host optimizer take most of the phase; 8 through PR
# 27, cut when serve_mesh came)
MOE_PLAN_LAYERS = 4


def release_pinned_cache() -> dict:
    """Give the host memory that freed pinned tensors left in PyTorch's
    caching host allocator back to the system, where this torch has a call
    for it, so that the next phase's pinned states can take it. Returns
    what was called and the host allocator's bytes before and after."""
    import torch

    gc.collect()
    before = host_allocator_bytes()
    called = None
    for name in ("_host_emptyCache", "_accelerator_emptyHostCache"):  # torch 2.11, 2.13
        fn = getattr(torch._C, name, None)
        if fn is not None:
            fn()
            called = name
            break
    return {"called": called, "host_cache_bytes_before": before,
            "host_cache_bytes_after": host_allocator_bytes()}


def phase_moe_kernels() -> dict:
    """The kernels at the MoE paths' shapes against their plain versions:
    flash forward and backward at 16 over 16 heads, no window, S 4096;
    paged attention at group 1 (``main`` and ``long``, pinned and device
    cold stores); RMSNorm at 4 x 2048 and 4096 x 2048; fused Adam on one
    pinned expert w1 (60 x 2048 x 1408)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [lambda: flash_case(TRAIN_SEQ, gen, True, heads=MOE_HEADS, window=0)]
    # the long cache's calls take tens of ms pinned: fewer repetitions
    cases += [lambda c=c, h=h: [{"kernel": "paged_attention", **paged_case(
        c, h, gen, MOE_HEADS, MOE_ARCH, **(dict(reps=5, inner=2) if c == "long" else {}))}]
              for c in ("main", "long") for h in (True, False)]
    cases += [lambda r=r: [{"kernel": "rmsnorm", **rmsnorm_case(r, gen, MOE_D)}]
              for r in (BATCH, TRAIN_SEQ)]
    cases += [lambda: [adam_case(True, gen, MOE_EXPERT_W1)]]
    rows = []
    for case in cases:
        for r in case():
            emit("kernel_vs_plain", path="moe", **r)
            rows.append(r)
        torch.cuda.empty_cache()
    return {k: max(r["max_abs_err"] for r in rows if r["kernel"] == k)
            for k in {r["kernel"] for r in rows}}


def phase_moe_serve(hw) -> dict[str, int]:
    """``qwen2-moe-a2.7b`` at full width and all 24 layers through
    ``serve_phase``: 28.6 GB of bf16 weights on the card."""
    from repro_torch.configs import get_config

    return serve_phase(get_config(MOE_ARCH), hw, "moe_serve")


def phase_moe_plan(hw) -> dict:
    """``qwen2-moe-a2.7b`` at full width through ``plan_phase`` at
    ``MOE_PLAN_LAYERS`` layers: 229 GB of training state at 24 layers, more
    than card and host hold (the host pins 15 at most), so the depth is the
    deepest up to that whose searched plan's pinned states fit the host."""
    from repro_torch.configs import get_config

    emit("moe_plan_host_cache", **release_pinned_cache(), host=host_memory())
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_PLAN_LAYERS)
    return plan_phase(cfg, hw, "moe_plan")


# ---------------------------------------------------------------------------
# The Mamba-2 family: mamba2-130m, and the hybrid (Jamba) at a reduced size
# ---------------------------------------------------------------------------
MAMBA_ARCH = "mamba2-130m"
MAMBA_SEQ = 32768  # mamba_plan's sequence: ProTrain's memory planning at its subject
MAMBA_WIDTHS = (768, 1536)  # d_model (norm1, final norm); d_in (the gated norm)
MAMBA_FP32_LEAF = (24, 24)  # A_log, D or dt_bias, stacked over the 24 layers
# the quantizer at mamba_plan's compress8 sites (32,768 tokens x d 768: a
# warp a row, 8 rows a block), at 257 rows (not a whole number of blocks)
# and at one row
QUANT_MAMBA_CASES = tuple(("activation", (z, MAMBA_WIDTHS[0])) for z in (MAMBA_SEQ, 257, 1))
HYBRID_ARCH = "jamba-1.5-large-398b"
# reduced Jamba at its head width and group: 8 query heads over 1 KV head of
# 128 (Jamba: 64 over 8); one 8-layer period, d 128, the rest of reduced()
HYBRID_HEADS = (8, 1)
HYBRID_SEQ = 2048  # its training steps' sequence (the MoE's capacity: 4,096 rows an expert)
# its kernels-vs-plain steps: the losses and gradient norms to train_compare's
# bounds. Each leaf's gradient cosine >= GRAD_COSINE (0.999, mistral's)
# with the plain path's MoE layers routed as the kernels' (``routing_choices``);
# >= 0.99 as each path routes itself: four MoE layers route on logits that
# move with the two paths' bf16 differences (MOE_ENGINE_TOL), so a choice
# flips and moves the gradients of every leaf upstream of it
HYBRID_GRAD_COSINE = 0.99
# the SSD in fp32 on the card against the same code on the CPU (no TF32):
# |cuda - cpu| <= SSD_TOL * max |cpu| of each output and gradient (fp32
# sums of up to 256 terms in another order)
SSD_TOL = 1e-4
SSD_SHAPE = (1, 4096, 24, 64, 128)  # B, S, H, P, N: mamba2-130m's heads at S 4096
# The JAX reference's profile of one mamba2-130m block at B 1, S 32,768
# (src/repro/core/profiler.py on jax 0.9.0, the CPU; tests/test_torch_mamba.py
# holds these numbers to it), printed beside the port's own.
REFERENCE_MAMBA_PROFILE = dict(flops_fwd=302529487228.0, hbm_bytes_fwd=21933764987,
                               act_residual_bytes=3510288480, boundary_bytes=50331648,
                               peak_transient_bytes=2136214624)


def hybrid_config():
    """Reduced Jamba at the kernels' widths: ``reduced()`` (one 8-layer
    period: Mamba-2 at positions 0-2 and 4-7, attention at 3, MoE every
    second layer of 4 experts top 2; d 128, d_ff 256, vocab 512, d_state
    16, SSD heads of 32, chunk 32) with the full model's head width, hd 128,
    and its group, 8 query heads a KV head."""
    from repro_torch.configs import get_config, reduced

    return reduced(get_config(HYBRID_ARCH), head_dim=HD, num_heads=HYBRID_HEADS[0],
                   num_kv_heads=HYBRID_HEADS[1])


def phase_mamba_kernels() -> dict:
    """The kernels at the Mamba-2 paths' shapes against their plain
    versions: RMSNorm at mamba2-130m's widths (768, and 1536 of the gated
    norm) in decode rows (4) and training rows (32,768); fused Adam on one
    fp32 leaf of 24 x 24 on the device (less than one block of the kernel);
    flash forward and backward at the hybrid's heads (8 over 1 of 128, S
    4096, no window); paged attention ``main`` at them (pinned and device
    cold stores); the quantizer at ``QUANT_MAMBA_CASES``."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [lambda r=r, d=d: [{"kernel": "rmsnorm", **rmsnorm_case(r, gen, d)}]
             for d in MAMBA_WIDTHS for r in (BATCH, MAMBA_SEQ)]
    cases += [lambda: [adam_case(False, gen, MAMBA_FP32_LEAF, fp32=True)]]
    cases += [lambda: flash_case(TRAIN_SEQ, gen, True, heads=HYBRID_HEADS, window=0)]
    cases += [lambda h=h: [{"kernel": "paged_attention", **paged_case(
        "main", h, gen, HYBRID_HEADS, HYBRID_ARCH)}] for h in (True, False)]
    cases += [lambda c=c, s=s: [quant_case(c, gen, s)] for c, s in QUANT_MAMBA_CASES]
    rows = []
    for case in cases:
        for r in case():
            emit("kernel_vs_plain", path="mamba", **r)
            rows.append(r)
        torch.cuda.empty_cache()
    return {k: max(r["max_abs_err"] for r in rows if r["kernel"] == k)
            for k in {r["kernel"] for r in rows}}


def phase_mamba_serve(hw) -> dict[str, int]:
    """``mamba2-130m`` at full width and ``MAMBA_SERVE_LAYERS`` of its 24
    layers through ``serve_phase``: the resident plan (its recurrent state,
    3.19 MB a layer at B 4), replay admission, the RMSNorm kernel at d 768
    and 1536."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(MAMBA_ARCH), num_layers=MAMBA_SERVE_LAYERS)
    return serve_phase(cfg, hw, "mamba_serve")


def ssd_check() -> dict:
    """``ssd_chunked`` in fp32 on the card against the same code on the CPU
    at ``SSD_SHAPE`` with an initial state: the output, the final state and
    the gradients of every input of <y, ct> + <state, cs>."""
    import torch

    from repro_torch.models.mamba2 import ssd_chunked

    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 would round the SSD's fp32 products"
    b, s, h, p, n = SSD_SHAPE
    gen = torch.Generator().manual_seed(4)
    inputs = [torch.randn(b, s, h, p, generator=gen), 0.05 + torch.rand(b, s, h, generator=gen),
              -(0.2 + torch.rand(h, generator=gen)), torch.randn(b, s, n, generator=gen),
              torch.randn(b, s, n, generator=gen), 0.5 * torch.randn(b, h, p, n, generator=gen)]
    ct, cs = torch.randn(b, s, h, p, generator=gen), torch.randn(b, h, p, n, generator=gen)
    outs = {}
    for dev in ("cpu", "cuda"):
        leaves = [t.to(dev).requires_grad_() for t in inputs]
        y, st = ssd_chunked(*leaves[:5], 256, leaves[5])
        grads = torch.autograd.grad((y * ct.to(dev)).sum() + (st * cs.to(dev)).sum(), leaves)
        outs[dev] = [t.detach().cpu() for t in (y, st, *grads)]
    names = ("y", "state", "dx", "ddt", "da", "db", "dc", "dstate0")
    errs = {k: (a - c).abs().max().item() for k, a, c in zip(names, outs["cuda"], outs["cpu"])}
    shares = {k: errs[k] / (SSD_TOL * c.abs().max().item()) for k, c in zip(names, outs["cpu"])}
    return {"shape": list(SSD_SHAPE), "chunk": 256, "max_abs_err": errs,
            "tol_share": shares, "tol": f"{SSD_TOL} * max |cpu| of each tensor",
            "ok": all(v <= 1.0 for v in shares.values())}


def ssd_timing() -> dict:
    """One mamba2-130m block's SSD at the plan's shape (B 1, S 32,768, 24
    heads of 64, N 128, chunk 256, fp32), CUDA-event timed: the whole
    ``ssd_chunked`` forward, and forward plus backward, beside its chunk
    loop alone (the 128-step recurrence over the chunk states, forward plus
    backward)."""
    import torch

    from repro_torch.models.mamba2 import chunk_scan, ssd_chunked

    b, s, h, p, n = 1, MAMBA_SEQ, 24, 64, 128
    gen = torch.Generator(device="cuda").manual_seed(5)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)  # noqa: E731
    x, bm, cm = rnd(b, s, h, p).bfloat16(), rnd(b, s, n).bfloat16(), rnd(b, s, n).bfloat16()
    dt = 0.05 + torch.rand(b, s, h, device="cuda", generator=gen)
    a = -(0.2 + torch.rand(h, device="cuda", generator=gen))
    leaves = [t.requires_grad_() for t in (x, dt, a, bm, cm)]
    ct = rnd(b, s, h, p).bfloat16()

    def fwd():
        with torch.no_grad():
            ssd_chunked(*leaves, 256)

    def fwd_bwd():
        y, _ = ssd_chunked(*leaves, 256)
        torch.autograd.grad(y, leaves, ct)

    nc = s // 256
    states = rnd(b, nc, h, p, n).requires_grad_()
    decay = torch.rand(b, nc, h, device="cuda", generator=gen).requires_grad_()
    ct_loop = rnd(b, nc, h, p, n)

    def loop():
        entering, _ = chunk_scan(states, decay, torch.zeros(b, h, p, n, device="cuda"))
        torch.autograd.grad(entering, (states, decay), ct_loop)

    return {"shape": [b, s, h, p, n], "chunk": 256, "ssd_fwd_ms": eager_ms(fwd),
            "ssd_fwd_bwd_ms": eager_ms(fwd_bwd), "chunk_loop_fwd_bwd_ms": eager_ms(loop),
            "chunk_loop_kernels_fwd": 2 * nc}


def phase_mamba_train_compare() -> None:
    """Two steps of full-width mamba2-130m at 2 layers, S 32,768, kernels
    (RMSNorm, fused Adam) against the plain path (plain RMSNorm and Adam);
    the SSD in fp32 on the card against the CPU; the SSD's time at the
    plan's shape."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import fully_resident_plan

    cfg = dataclasses.replace(get_config(MAMBA_ARCH), num_layers=2)
    shape = ShapeConfig("compare", MAMBA_SEQ, 1, "train")
    plan = fully_resident_plan(4, 2)
    t0 = time.perf_counter()
    r = compare_step(cfg, shape, plan, steps=2)
    emit("mamba_train_compare", case="resident", plan=plan.describe(), arch=cfg.name,
         layers=cfg.num_layers, seq=MAMBA_SEQ, batch=1, **r,
         tol={"loss": LOSS_TOL, "grad_norm_rel": NORM_RTOL, "cosine": GRAD_COSINE},
         seconds=time.perf_counter() - t0)
    for a, b in zip(r["losses_kernels"], r["losses_plain"]):
        assert abs(a - b) <= LOSS_TOL, r
    assert r["grad_norm_rel_diff"] <= NORM_RTOL, r
    assert r["min_grad_cosine"] >= GRAD_COSINE, r
    assert r["launches"]["rmsnorm"] > 0 and r["launches"]["fused_adam"] > 0, r["launches"]
    torch.cuda.empty_cache()
    ssd = ssd_check()
    emit("mamba_ssd_fp32", **ssd)
    assert ssd["ok"], ssd
    emit("mamba_ssd_timing", **ssd_timing())
    torch.cuda.empty_cache()


def phase_mamba_plan(hw) -> dict:
    """``mamba2-130m`` at full width and all 24 layers, S 32,768, B 1,
    through ``plan_phase``, beside the reference's profile: 24 blocks of
    3.51 GB of activations against the card's 85.0 GB."""
    from repro_torch.configs import get_config

    return plan_phase(get_config(MAMBA_ARCH), hw, "mamba_plan", REFERENCE_MAMBA_PROFILE,
                      seq=MAMBA_SEQ)


def phase_hybrid(hw) -> dict[str, int]:
    """The hybrid at a reduced size (``hybrid_config``): the engine on the
    paged plan under chunked admission, graph against eager, and the
    teacher-forced step (``serve_phase``); then two training steps, kernels
    (flash, RMSNorm, fused Adam) against the plain path, at S 2048, B 1.
    Both as each path routes itself and with the plain path routed as the
    kernels' (``routing="pinned"``). Returns the kernels' launches over the
    serving run and the first pair of steps."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import fully_resident_plan

    cfg = hybrid_config()
    launches = serve_phase(cfg, hw, "hybrid_serve")
    shape = ShapeConfig("hybrid", HYBRID_SEQ, 1, "train")
    plan = fully_resident_plan(3, 1)
    runs = {}
    for routing, cosine in (("own", HYBRID_GRAD_COSINE), ("pinned", GRAD_COSINE)):
        t0 = time.perf_counter()
        r = runs[routing] = compare_step(cfg, shape, plan, steps=2,
                                         pin_routing=routing == "pinned")
        emit("hybrid_train", routing=routing, plan=plan.describe(), arch=cfg.name,
             layers=cfg.num_layers, d_model=cfg.d_model,
             heads=[cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim],
             reductions="reduced(): d 128, d_ff 256, vocab 512, 4 experts, d_state 16, SSD "
                        "heads of 32, chunk 32, one 8-layer period; heads 8 over 1 of 128 kept",
             seq=HYBRID_SEQ, batch=1, **r,
             tol={"loss": LOSS_TOL, "grad_norm_rel": NORM_RTOL, "cosine": cosine},
             seconds=time.perf_counter() - t0)
        for a, b in zip(r["losses_kernels"], r["losses_plain"]):
            assert abs(a - b) <= LOSS_TOL, (routing, r)
        assert r["grad_norm_rel_diff"] <= NORM_RTOL, (routing, r)
        assert r["min_grad_cosine"] >= cosine, (routing, r)
    r = runs["own"]
    for name in ("flash_attention", "flash_attention_bwd", "rmsnorm", "fused_adam"):
        assert r["launches"][name] > 0, f"{name} was not launched by the hybrid's steps"
    torch.cuda.empty_cache()
    return {k: launches.get(k, 0) + r["launches"].get(k, 0)
            for k in set(launches) | set(TRAINING_KERNELS)}


# ---------------------------------------------------------------------------
# The encoder-decoder family: seamless-m4t-large-v2 at full width and depth
# ---------------------------------------------------------------------------
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_HEADS, ENCDEC_HD = (16, 16), 64  # 16 query over 16 KV heads of 64: group 1
ENCDEC_FLASH_CASES = (  # (query rows, key rows, causal): decoder self, encoder self, cross
    (TRAIN_SEQ, TRAIN_SEQ, True), (TRAIN_SEQ, TRAIN_SEQ, False), (1024, TRAIN_SEQ, False))
ENCDEC_PROMPT_LENS = (595, 759)  # prompts of 595 to 758 tokens, past the 2-page hot window
ENCDEC_SEQ, ENCDEC_FALLBACK_SEQ = 32768, 16384  # encdec_plan's frames and tokens
# encdec_serve's and encdec_plan's depth: 8 encoder and 8 decoder layers
# of 24 + 24, cut for the run's time (12 + 12 once the VLM's phases came,
# 8 + 8 once the distributed ones did: 76 s of an 854 s run at 12 + 12)
ENCDEC_LAYERS = 8
ENCDEC_FRAMES_SEED = 11
# the reference's block profile of seamless-m4t-large-v2 at B 1, S 32,768
# (src/repro/core/profiler.py, profile_superblock; tests/test_torch_encdec.py
# holds these numbers)
REFERENCE_ENCDEC_PROFILE = dict(flops_fwd=5850971183329.0, hbm_bytes_fwd=1120896937592,
                                act_residual_bytes=5436609280, boundary_bytes=67108864,
                                peak_transient_bytes=5213524096)


def phase_encdec_kernels() -> list[dict]:
    """The kernels at seamless-m4t-large-v2's heads (16 over 16 of 64, B 1)
    against their plain versions: flash forward and backward causal at S
    4096 (the decoder's self-attention), non-causal at S 4096 (the
    encoder's) and non-causal 1024 query rows over 4096 key rows (a
    cross-attention with S != S_src), each beside SDPA and the bound; the
    paged kernel ``main`` at hd 64, group 1, cold store pinned and on the
    device."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [lambda s=s, sk=sk, c=c: flash_case(s, gen, True, heads=ENCDEC_HEADS, window=0,
                                                hd=ENCDEC_HD, causal=c, sk=sk)
             for s, sk, c in ENCDEC_FLASH_CASES]
    cases += [lambda h=h: [{"kernel": "paged_attention", **paged_case(
        "main", h, gen, ENCDEC_HEADS, ENCDEC_ARCH, hd=ENCDEC_HD)}] for h in (True, False)]
    rows = []
    for case in cases:
        for r in case():
            emit("kernel_vs_plain", path="encdec", **r)
            rows.append(r)
        torch.cuda.empty_cache()
    return rows


def prime_from_frames(cfg):
    """``serve``'s hook for an encoder-decoder: ``encode`` over seeded
    frames (B, SEQ_LEN, D), then ``prime_cross_cache`` into the engine's
    cache, in place."""
    import torch

    from repro_torch.models.kvcache import prime_cross_cache
    from repro_torch.models.model import encode

    def prime(engine):
        gen = torch.Generator(device="cuda").manual_seed(ENCDEC_FRAMES_SEED)
        frames = torch.randn(BATCH, SEQ_LEN, cfg.d_model, device="cuda",
                             generator=gen).bfloat16()
        params = engine.state["params"]
        with torch.no_grad():
            prime_cross_cache(params, encode(params, frames, cfg), engine.state["cache"], cfg)

    return prime


def encdec_cut():
    """seamless-m4t-large-v2 at full width, ``ENCDEC_LAYERS`` encoder and
    decoder layers."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(ENCDEC_ARCH), num_layers=ENCDEC_LAYERS,
                               encoder_layers=ENCDEC_LAYERS)


def phase_encdec_serve(hw) -> dict[str, int]:
    """``seamless-m4t-large-v2``'s decoder at full width, ``ENCDEC_LAYERS``
    + ``ENCDEC_LAYERS`` layers, through ``serve_phase`` on the paged plan,
    each slot's cross cache primed from the encoder over seeded frames (4,
    1024, 1024)."""
    cfg = encdec_cut()
    return serve_phase(cfg, hw, "encdec_serve", prompt_lens=ENCDEC_PROMPT_LENS,
                       prime=prime_from_frames(cfg))


def phase_encdec_train_compare() -> dict[str, int]:
    """Two steps of full-width seamless-m4t-large-v2 at 2 encoder and 2
    decoder layers, S 4096 frames and tokens, B 1: the kernels (flash in
    the encoder, the decoder's self- and cross-attention, fused Adam)
    against the plain path (whole-row attention, plain Adam), to the
    train_compare bounds. Returns the kernels' launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import fully_resident_plan

    cfg = dataclasses.replace(get_config(ENCDEC_ARCH), num_layers=2, encoder_layers=2)
    shape = ShapeConfig("compare", TRAIN_SEQ, 1, "train")
    plan = fully_resident_plan(4, 2)
    t0 = time.perf_counter()
    r = compare_step(cfg, shape, plan, steps=2)
    emit("encdec_train_compare", case="resident", plan=plan.describe(), arch=cfg.name,
         layers=cfg.num_layers, encoder_layers=cfg.encoder_layers, seq=TRAIN_SEQ, batch=1,
         **r, tol={"loss": LOSS_TOL, "grad_norm_rel": NORM_RTOL, "cosine": GRAD_COSINE},
         seconds=time.perf_counter() - t0)
    for a, b in zip(r["losses_kernels"], r["losses_plain"]):
        assert abs(a - b) <= LOSS_TOL, r
    assert r["grad_norm_rel_diff"] <= NORM_RTOL, r
    assert r["min_grad_cosine"] >= GRAD_COSINE, r
    # per step: 2 encoder layers (forward, recompute, backward) and 2 decoder
    # layers of self- and cross-attention (forward, backward)
    want = {"flash_attention": 2 * (2 * 2 + 2 * 2), "flash_attention_bwd": 2 * (2 + 2 * 2),
            "rmsnorm": 0}
    got = {k: r["launches"][k] for k in want}
    assert got == want and r["launches"]["fused_adam"] > 0, (got, want, r["launches"])
    torch.cuda.empty_cache()
    return {k: r["launches"][k] for k in TRAINING_KERNELS}


def phase_encdec_plan(hw) -> dict:
    """``seamless-m4t-large-v2`` at full width, ``ENCDEC_LAYERS`` +
    ``ENCDEC_LAYERS`` layers, through ``plan_phase`` at S 32,768 frames and
    tokens, B 1, beside the reference's block profile; at S 16,384 if no
    searched plan trains at 32,768 (``encdec_plan_failed`` reports the
    attempts)."""
    cfg = encdec_cut()
    emit("encdec_plan_host_cache", **release_pinned_cache(), host=host_memory())
    try:
        return plan_phase(cfg, hw, "encdec_plan", REFERENCE_ENCDEC_PROFILE, seq=ENCDEC_SEQ)
    except NoPlanTrained as err:
        emit("encdec_plan_failed", seq=ENCDEC_SEQ, attempts=err.attempts,
             next_seq=ENCDEC_FALLBACK_SEQ)
    gc.collect()
    release_pinned_cache()
    return plan_phase(cfg, hw, "encdec_plan", seq=ENCDEC_FALLBACK_SEQ)


# ---------------------------------------------------------------------------
# The vision-language family: llava-next-34b at full width
# ---------------------------------------------------------------------------
VLM_ARCH = "llava-next-34b"
VLM_HEADS = (56, 8)  # 56 query over 8 KV heads of 128: group 7
VLM_D, VLM_FF = 7168, 20480
VLM_PATCHES = 1024  # the pipeline's min(1024, S) from S 1024 on
VLM_SEQ = TRAIN_SEQ + VLM_PATCHES  # positions through the blocks in training: 5,120
VLM_PREFILL_TOKENS = 1024  # vlm_prefill: 1024 patches, then 1024 tokens, B 4
VLM_PATCHES_SEED = 13
# depth cuts for the run's time: vlm_serve and vlm_prefill served all 60
# layers before, and vlm_plan bisected down from 60 (13 fit the host)
# (20 of them since the tp phase grew to every family, 10 since serve_mesh)
VLM_SERVE_LAYERS, VLM_PLAN_LAYERS = 10, 8


def vlm_config(layers: int):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(VLM_ARCH), num_layers=layers)


def phase_vlm_kernels() -> list[dict]:
    """The kernels at llava-next-34b's shapes against their plain versions:
    flash forward and backward at 56 over 8 heads of 128, causal over S
    5,120 (1,024 patches and 4,096 tokens), B 1; the paged kernel ``main``
    at group 7, and mistral-7b's group 4 in the same call, cold store
    pinned and on the device; RMSNorm at 4 x 7168 (decode) and 5,120 x
    7,168; fused Adam on one w1 (7168 x 20480) with its states on the
    device and pinned; the quantizer at 5,120 x 7,168 bf16 (a compressed
    site of a training step), bitwise."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [lambda: flash_case(VLM_SEQ, gen, True, heads=VLM_HEADS, window=0)]
    cases += [lambda h=h, heads=heads, arch=arch: [{"kernel": "paged_attention", **paged_case(
        "main", h, gen, heads, arch)}] for heads, arch in ((VLM_HEADS, VLM_ARCH),
                                                             ((HQ, HKV), "mistral-7b"))
              for h in (True, False)]
    cases += [lambda r=r: [{"kernel": "rmsnorm", **rmsnorm_case(r, gen, VLM_D)}]
              for r in (BATCH, VLM_SEQ)]
    cases += [lambda h=h: [adam_case(h, gen, (VLM_D, VLM_FF))] for h in (False, True)]
    cases += [lambda: [quant_case("activation", gen, (VLM_SEQ, VLM_D))]]
    rows = []
    for case in cases:
        for r in case():
            emit("kernel_vs_plain", path="vlm", **r)
            rows.append(r)
        torch.cuda.empty_cache()
    return rows


def phase_vlm_serve(hw) -> tuple[dict[str, int], dict]:
    """llava-next-34b at full width and ``VLM_SERVE_LAYERS`` layers (12.0
    GB of bf16 weights) through ``serve_phase`` on the paged plan, chunked admission,
    prompts of 595 to 758 tokens: the engine serves its tokens, as the JAX
    engine does (patches enter only through ``forward``). Returns the
    launches and a record of the weights, prompts and tokens."""
    import torch

    from repro_torch.models.model import init_params

    cfg = vlm_config(VLM_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    emit("vlm_init", arch=cfg.name, layers=cfg.num_layers, params=cfg.param_count(),
         weight_bytes=torch.cuda.memory_allocated(), seconds=time.perf_counter() - t0,
         card_total_bytes=torch.cuda.mem_get_info()[1])
    record = {"params": params}
    launches = serve_phase(cfg, hw, "vlm_serve", prompt_lens=ENCDEC_PROMPT_LENS, params=params,
                           record=record)
    n = launches["paged_attention"]
    assert n % cfg.num_layers == 0 and n > 0, f"vlm_serve: {n} paged launches, not 1 a layer"
    return launches, record


def greedy_check(got, plain, what: str) -> dict:
    """(B, V) logits against the plain path's: max |diff| within ENGINE_TOL
    * (1 + max |logit|), and the greedy token equal in every row whose plain
    top-1 leads its top-2 by more than that tolerance (a row inside it may
    flip on bf16 noise alone); the share of rows that agree reported."""
    got, plain = got.float(), plain.float()
    err = (got - plain).abs().max().item()
    scale = plain.abs().max().item()
    tol = ENGINE_TOL * (1 + scale)
    top2 = plain.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    agree = got.argmax(-1) == plain.argmax(-1)
    out = {"max_abs_diff": err, "max_abs_logit": scale, "tol": tol,
           "argmax_agree": agree.float().mean().item(), "top2_margin": margin.tolist(),
           "rows_past_margin": int((margin > tol).sum())}
    assert err <= tol, f"{what}: logits differ by {err} (max |logit| {scale}, bound {tol})"
    assert bool(agree[margin > tol].all()), f"{what}: a greedy token past the margin differs: {out}"
    return out


def phase_vlm_prefill(record: dict) -> dict[str, int]:
    """``build_prefill_step(chunk=None)`` for llava-next-34b at the served
    depth (``VLM_SERVE_LAYERS``) on the served weights, B 4, 1,024 seeded
    patches ahead of 1,024 tokens: through the kernels against the plain
    path (whole-row attention, plain
    RMSNorm; a row at a time) at ENGINE_TOL; with the patches against
    zeroed patches (the logits must move); without patches, over each
    served prompt, against the engine's first token for it; its device
    time. Returns the kernels' launches of one call."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import MemoryPlan
    from repro_torch.models.model import num_repeats
    from repro_torch.train.step_builder import build_prefill_step

    gc.collect()  # the engines' caches and graphs
    torch.cuda.empty_cache()
    cfg = vlm_config(VLM_SERVE_LAYERS)
    params = record["params"]
    n = num_repeats(cfg) + 2
    plan = MemoryPlan(n, num_repeats(cfg), n_persist=n)
    gen = torch.Generator(device="cuda").manual_seed(VLM_PATCHES_SEED)
    tokens = torch.randint(1, cfg.vocab_size, (BATCH, VLM_PREFILL_TOKENS), device="cuda",
                           generator=gen)
    patches = torch.randn(BATCH, VLM_PATCHES, cfg.d_model, device="cuda",
                          generator=gen).bfloat16()
    step = build_prefill_step(cfg, plan, "cuda",
                              ShapeConfig("vlm_prefill", VLM_PREFILL_TOKENS, BATCH, "prefill"))
    batch = {"tokens": tokens, "patches": patches}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    logits = step.fn(params, batch)
    torch.cuda.synchronize()
    launches = {k: K.launch_counts()[k] for k in ("flash_attention", "rmsnorm")}
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": cfg.num_layers, "rmsnorm": decode_norms(cfg)}
    assert launches == want, f"vlm_prefill: launches {launches}, one call makes {want}"
    device_ms = eager_ms(lambda: step.fn(params, batch), reps=3, inner=1)
    zeroed = step.fn(params, {"tokens": tokens, "patches": torch.zeros_like(patches)}).float()
    moved = {"max_abs_diff_patches_vs_zero": (logits.float() - zeroed).abs().max().item(),
             "argmax_differs_rows": int((logits.argmax(-1) != zeroed.argmax(-1)).sum())}
    assert moved["max_abs_diff_patches_vs_zero"] > 0, f"the patches did not move the logits: {moved}"
    del zeroed
    one = build_prefill_step(cfg, plan, "cuda", ShapeConfig("row", VLM_PREFILL_TOKENS, 1,
                                                              "prefill"), attn_impl="naive")
    with plain_rmsnorm():
        plain = torch.cat([one.fn(params, {"tokens": tokens[i:i + 1],
                                           "patches": patches[i:i + 1]}) for i in range(BATCH)])
    vs_plain = greedy_check(logits, plain, "vlm_prefill kernels vs plain")
    # without patches, over each served prompt: the stateless prefill's
    # greedy token against the engine's first (chunked prefill, paged kernel)
    firsts = []
    for prompt in record["prompts"]:
        p_step = build_prefill_step(cfg, plan, "cuda", ShapeConfig("prompt", len(prompt), 1,
                                                                   "prefill"))
        firsts.append(p_step.fn(params, {"tokens": torch.tensor([prompt], device="cuda")}))
    firsts = torch.cat(firsts).float()
    engine = torch.tensor([record["finished"][i][0] for i in range(BATCH)], device="cuda")
    top2 = firsts.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    tol = ENGINE_TOL * (1 + firsts.abs().max().item())
    same = firsts.argmax(-1) == engine
    vs_engine = {"stateless_tokens": firsts.argmax(-1).tolist(), "engine_tokens": engine.tolist(),
                 "agree": same.float().mean().item(), "top2_margin": margin.tolist(),
                 "tol": tol, "prompt_lens": [len(p) for p in record["prompts"]]}
    # 2 x the block matmul parameters at every position, the head at the
    # last one, and the causal attention products of every layer
    pos, head = VLM_PATCHES + VLM_PREFILL_TOKENS, cfg.vocab_size * cfg.d_model
    flops = BATCH * (2 * (active_matmul_params(cfg) - head) * pos + 2 * head + 4
                     * cfg.resolved_head_dim * cfg.num_heads * cfg.num_layers
                     * attended_pairs(pos, 0))
    emit("vlm_prefill", arch=cfg.name, layers=cfg.num_layers, batch=BATCH,
         patches=VLM_PATCHES, tokens=VLM_PREFILL_TOKENS, launches=launches,
         device_ms=device_ms, peak_device_bytes=peak, model_flops=flops,
         mfu=flops / (device_ms / 1e3) / BF16_FLOP_PER_S,
         kernels_vs_plain=vs_plain, patches_moved=moved, no_patches_vs_engine=vs_engine)
    assert bool(same[margin > tol].all()), (
        f"the stateless prefill's greedy token differs from the engine's past the margin: "
        f"{vs_engine}")
    return launches


def phase_vlm_train_compare() -> dict[str, int]:
    """Two steps of full-width llava-next-34b at 2 layers, S 4096 tokens
    after 1,024 patches, B 1, both layers recomputed in the backward: the
    kernels against the plain path (whole-row attention, plain RMSNorm and
    Adam), to the train_compare bounds. The plain path's attention keeps
    8.8 GB a layer at S 5,120 (fp32 probabilities and their bf16 copy)
    beside 32.6 GB of resident training state, so both layers are
    recomputed to leave the card room. Returns the kernels' launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import MemoryPlan

    cfg = dataclasses.replace(get_config(VLM_ARCH), num_layers=2)
    shape = ShapeConfig("compare", TRAIN_SEQ, 1, "train")
    plan = MemoryPlan(4, 2, n_persist=4, n_checkpoint=2)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    r = compare_step(cfg, shape, plan, steps=2)
    emit("vlm_train_compare", case="checkpoint", plan=plan.describe(), arch=cfg.name,
         layers=cfg.num_layers, seq=TRAIN_SEQ, patches=VLM_PATCHES, batch=1, **r,
         tol={"loss": LOSS_TOL, "grad_norm_rel": NORM_RTOL, "cosine": GRAD_COSINE},
         peak_device_bytes=torch.cuda.max_memory_allocated(),
         seconds=time.perf_counter() - t0)
    for a, b in zip(r["losses_kernels"], r["losses_plain"]):
        assert abs(a - b) <= LOSS_TOL, r
    assert r["grad_norm_rel_diff"] <= NORM_RTOL, r
    assert r["min_grad_cosine"] >= GRAD_COSINE, r
    # per step: each layer's flash forward twice (the forward and its
    # replay) and backward once, its two RMSNorms twice and the final one
    want = {"flash_attention": 2 * 2 * 2, "flash_attention_bwd": 2 * 2,
            "rmsnorm": 2 * (2 * 2 * 2 + 1)}
    got = {k: r["launches"][k] for k in want}
    assert got == want and r["launches"]["fused_adam"] > 0, (got, want, r["launches"])
    torch.cuda.empty_cache()
    return {k: r["launches"][k] for k in TRAINING_KERNELS}


def phase_vlm_plan(hw) -> dict:
    """llava-next-34b at full width through ``plan_phase`` at S 4096 tokens
    after 1,024 patches, B 1, ``VLM_PLAN_LAYERS`` layers (550.2 GB of
    training state at 60 layers, more than card and host hold): the depth
    is at most that, and the deepest below whose searched plan's pinned
    states fit the host (``depth_cuts``). The block profile, the
    reference's, counts S positions where the blocks run S + 1,024, so the
    first searched plan may run out of memory (``oom_attempts``)."""
    emit("vlm_plan_host_cache", **release_pinned_cache(), host=host_memory())
    return plan_phase(vlm_config(VLM_PLAN_LAYERS), hw, "vlm_plan")


# ---------------------------------------------------------------------------
# Distributed gradient sync (train/sync.py, dist/collectives.py)
# ---------------------------------------------------------------------------
DIST_LAYERS, DIST_BATCH, DIST_STEPS = 4, 2, 3
# Each manual kind against xla_int8_ef at world one, where no value crosses
# a wire: ddp and zero2 do the same arithmetic (one per-tensor scale, which
# the quantizer's one chunk at z = 1 computes bitwise), so their losses and
# fp32 masters must equal its bitwise. zero3 quantizes each layer's slice of
# a stacked run apart (a scale a repeat), so it is held by bounds: its
# losses within DIST_ZERO3_RTOL relative, and its masters' gap to
# xla_int8_ef's within DIST_ZERO3_UPDATE_GAP of xla_int8_ef's own update
# ||master - init||, which a sync that lost or zeroed the gradients (no
# update: a gap of 1) fails. Measured on an H100 at 700 W: losses 5.0e-5
# apart, a gap of 0.184; the bounds are 4x and 1.6x those.
DIST_ZERO3_RTOL = 2e-4
DIST_ZERO3_UPDATE_GAP = 0.3
# the sync's quantizer chunks: mistral-7b's w1 / w3 / w2 (4096 x 14336 values)
# and wq (4096 x 4096) at z = 1, the card's one rank (its own chunk, me 0),
# and w1 at z = 4 (QUANT_WIRE)
DIST_QUANT_CASES = (("wire_own", (1, 4096 * 14336)), ("wire_own", (1, 4096 * 4096)),
                    ("wire", QUANT_WIRE))
DIST_RANKS_LAYERS, DIST_RANKS_STEPS = 2, 3  # the first step of a fresh process warms up
DIST_KINDS = ("ddp", "zero2", "zero3")


def dist_plans(nc: int, nb: int) -> dict:
    """The dist phases' plans: the xla path with each wire format, every
    chunk persistent; the manual kinds with int8 + EF: ddp (every chunk
    persistent), zero2 and zero3 (every chunk ZeRO-sharded; zero3 buffers
    its last 3 chunks, so its last two layers form a buffered run gathered
    one layer ahead, its first two are gathered again for the backward)."""
    from repro_torch.core.plan import MemoryPlan

    out = {f"xla_{c}": MemoryPlan(nc, nb, n_persist=nc, grad_compress=c)
           for c in ("none", "bf16", "int8_ef")}
    manual = dict(sync_mode="manual", grad_compress="int8_ef")
    out["ddp"] = MemoryPlan(nc, nb, n_persist=nc, **manual)
    out["zero2"] = MemoryPlan(nc, nb, n_persist=0, zero_stage=2, **manual)
    out["zero3"] = MemoryPlan(nc, nb, n_persist=0, n_buffer=3, **manual)
    return out


def expected_quant_launches(art, state, kind: str, steps: int) -> int:
    """The sync's fused_quantize_ef calls: one a sharded leaf a microbatch
    (zero3: one a sharded leaf of each repeat, gathered per repeat); none
    for replicated leaves, which the plain per-tensor quantizer syncs."""
    from repro_torch.optim.adam import tree_leaves

    if kind == "xla":  # the xla path's int8 numerics are the plain per-tensor ones
        return 0
    run_leaves = {id(t) for t in tree_leaves(state["params"]["runs"])}
    n = sum((p.shape[0] if kind == "zero3" and id(p) in run_leaves else 1)
            for p, ls in zip(tree_leaves(state["params"]), art.leaf_syncs)
            if ls.dim is not None)
    return n * steps * art.plan.microbatch


def _paths(tree, prefix: str = "") -> list:
    """(path, leaf) of a nested dict in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def stacked_masters(state) -> dict:
    """The fp32 masters by leaf path on the card (a host chunk's copied from
    pinned memory), a run layout's ``runs`` stacked back into ``blocks`` (at
    world one a shard is its full leaf)."""
    import torch

    master = state["opt"]["master"]
    out = {p: t.to("cuda") for p, t in _paths({k: v for k, v in master.items()
                                                 if k != "runs"})}
    runs = [{p: t.to("cuda") for p, t in _paths(r)} for r in master["runs"]]
    for p in runs[0]:
        out["/blocks" + p] = torch.cat([r[p] for r in runs]) if len(runs) > 1 else runs[0][p]
    return out


def master_gap(got: dict, ref: dict, init: dict) -> dict:
    """How far the masters ``got`` lie from ``ref`` (both after the same
    steps from the parameters ``init``): elements that differ, the largest
    difference, ``update_gap`` = ||got - ref|| / ||ref - init|| and
    ``update_ratio`` = ||got - init|| / ||ref - init|| (fp32 norms)."""
    n_diff, max_abs, gap, upd, own = 0, 0.0, 0.0, 0.0, 0.0
    for p, r in ref.items():
        g, i = got[p], init[p].float()
        n_diff += int((g != r).sum())
        max_abs = max(max_abs, float((g - r).abs().max()))
        gap += float((g - r).norm()) ** 2
        upd += float((r - i).norm()) ** 2
        own += float((g - i).norm()) ** 2
    return {"elements": sum(r.numel() for r in ref.values()), "differ": n_diff,
            "max_abs_diff": max_abs, "update_norm": math.sqrt(upd),
            "update_gap": math.sqrt(gap / upd), "update_ratio": math.sqrt(own / upd)}


def dist_run(cfg, shape, plan, params, steps: int, mesh, kind: str | None = None,
             warmup: int = 0, profile: bool = False, ref_masters: dict | None = None,
             keep_masters: bool = False, sharded: bool = False) -> dict:
    """``steps`` timed steps of ``plan`` from ``params`` (stacked ``blocks``)
    with the launch counts zeroed just before: losses, each step's time
    (the median over the steps after ``warmup``), peak device bytes,
    ``ef_norm``, launches; with ``profile``, then one more step under the
    profiler (``profile_step``). ``kind``: build the manual
    kind's ``ManualSync`` directly (a world of one, where ``make_strategy``
    routes a manual plan to ``XlaSync``); ``sharded``: build the xla
    path's sharded ``XlaSync`` directly (at world one ``make_strategy``
    routes an xla plan to the single-device step). The fp32 masters after
    the timed steps, before the profiled one: with ``ref_masters`` their
    ``master_gap`` to those (``"masters"``); with ``keep_masters`` they
    are returned (``"_masters"``, on the device)."""
    import torch

    from repro_torch import kernels as K
    from repro_torch import obs
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.step_builder import build_train_step
    from repro_torch.train.sync import ManualSync, XlaSync

    tel = obs.Telemetry(trace=False)
    strategy = (ManualSync(plan, mesh, kind) if kind is not None
                else XlaSync(plan, mesh, sharded=True) if sharded else None)
    art = build_train_step(cfg, plan, mesh.device, shape, mesh=mesh, strategy=strategy,
                           adam=AdamConfig(lr=3e-4), telemetry=tel)
    state = art.place_state(_relayout(params, art.runs))
    pipe = SyntheticTokenPipeline(cfg, shape, seed=0, device=mesh.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, times, ef_norms = [], [], []
    for _ in range(steps):
        batch = pipe.next_sync()
        t0 = time.perf_counter()
        state, m = art.fn(state, batch)
        losses.append(float(m["loss"]))  # waits for the step
        times.append(time.perf_counter() - t0)
        if "ef_norm" in m:
            ef_norms.append(float(m["ef_norm"]))
    torch.cuda.synchronize()
    launches = dict(K.launch_counts())
    snap = {k: v["value"] for k, v in tel.registry.snapshot().items() if "value" in v}
    masters = stacked_masters(state) if ref_masters is not None or keep_masters else None
    gap = (master_gap(masters, ref_masters, dict(_paths(params)))
           if ref_masters is not None else None)
    # a copy to keep: a one-run layout's masters are the state's, which the
    # profiled step updates
    masters = {p: t.clone() for p, t in masters.items()} if keep_masters else None
    out = {"plan": plan.describe(), "strategy": art.strategy.kind,
           "sharded_leaves": sum(ls.dim is not None for ls in art.leaf_syncs),
           "leaves": len(art.leaf_syncs), "losses": losses, "step_times_s": times,
           "median_step_s": statistics.median(times[warmup:]), "ef_norms": ef_norms,
           "peak_device_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
           "pinned_state_bytes": pinned_state_bytes(state),
           "sharded": getattr(art.strategy, "sharded", None),
           "expected_quant_launches": expected_quant_launches(
               art, state, art.strategy.kind, steps),
           "sync": {k: v for k, v in snap.items() if k.startswith("sync.")}}
    if gap is not None:
        out["masters"] = gap
    if profile:
        out["profile"] = profile_step(art, state, pipe.next_sync())
    if masters is not None:
        out["_masters"] = masters
    del state, art
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_dist_run(name: str, run: dict, reference: dict | None) -> None:
    """Finite losses, every training kernel launched, the quantizer's
    launches the plan's, residuals above zero under int8 + EF; with
    ``reference`` (xla_int8_ef's run at world one) the manual kind held to
    it as ``DIST_ZERO3_RTOL`` says: ddp and zero2 bitwise, zero3 by bounds."""
    assert all(math.isfinite(x) for x in run["losses"]), (name, run["losses"])
    kernels = ("flash_attention", "flash_attention_bwd", "rmsnorm", "fused_adam")
    for k in kernels:
        assert run["launches"].get(k, 0) > 0, f"{name}: {k} was not launched"
    quant = run["launches"].get("fused_quantize_ef", 0)
    assert quant == run["expected_quant_launches"], (name, quant, run["expected_quant_launches"])
    if run["strategy"] in ("zero2", "zero3"):
        assert quant > 0, f"{name}: the sync never launched fused_quantize_ef"
    if "int8_ef" in run["plan"]:
        assert run["ef_norms"] and min(run["ef_norms"]) > 0, (name, run["ef_norms"])
    if reference is None:
        return
    got, want, gap = run["losses"], reference["losses"], run["masters"]
    assert gap["update_norm"] > 0, (name, gap)  # the reference itself moved
    if run["strategy"] in ("ddp", "zero2"):
        assert got == want, (name, got, want)
        assert gap["differ"] == 0, (name, gap)
    else:
        for a, b in zip(got, want):
            assert abs(a - b) <= DIST_ZERO3_RTOL * abs(b), (name, got, want)
        assert gap["update_gap"] <= DIST_ZERO3_UPDATE_GAP, (name, gap)


def phase_dist_sync() -> tuple[dict[str, int], list[dict]]:
    """mistral-7b at full width, ``DIST_LAYERS`` layers, B 2, S 4096: the
    xla path's wire formats (none, bf16, int8 + EF) through
    ``make_strategy`` on one rank, then the manual ddp / zero2 / zero3 with
    int8 + EF built directly at world one over a one-rank NCCL group, 3
    timed steps each from one init; every manual kind's losses and fp32
    masters against ``xla_int8_ef``'s (``check_dist_run``). Then the quantizer against its plain
    version, bitwise, at the sync's chunk shapes (``DIST_QUANT_CASES``).
    Returns the manual kinds' launches, summed, and the quantizer's rows."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import LocalMesh, make_local_mesh
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("mistral-7b"), num_layers=DIST_LAYERS)
    shape = ShapeConfig("dist", TRAIN_SEQ, DIST_BATCH, "train")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    plans = dist_plans(DIST_LAYERS + 2, DIST_LAYERS)
    runs = {}
    for name in ("xla_none", "xla_bf16", "xla_int8_ef"):
        runs[name] = dist_run(cfg, shape, plans[name], params, DIST_STEPS,
                              LocalMesh(0, 1, None, torch.device("cuda", 0)), profile=True,
                              keep_masters=name == "xla_int8_ef")
        assert runs[name]["strategy"] == "xla", runs[name]["strategy"]
        check_dist_run(name, runs[name], None)
        emit("dist_sync", case=name, layers=DIST_LAYERS, batch=DIST_BATCH, seq=TRAIN_SEQ,
             **{k: v for k, v in runs[name].items() if k != "_masters"})
    ref = runs["xla_int8_ef"]
    store = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    launches: dict[str, int] = {}
    try:
        mesh = make_local_mesh("cuda:0")
        for kind in DIST_KINDS:
            r = dist_run(cfg, shape, plans[kind], params, DIST_STEPS, mesh=mesh, kind=kind,
                         profile=True, ref_masters=ref["_masters"])
            assert r["strategy"] == kind, r["strategy"]
            emit("dist_sync", case=kind, layers=DIST_LAYERS, batch=DIST_BATCH, seq=TRAIN_SEQ,
                 world=1, process_group="nccl, one rank (ManualSync built directly)",
                 against="xla_int8_ef", bitwise=kind != "zero3",
                 loss_rtol=None if kind != "zero3" else DIST_ZERO3_RTOL,
                 update_gap_bound=None if kind != "zero3" else DIST_ZERO3_UPDATE_GAP, **r)
            check_dist_run(kind, r, ref)
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    del params, ref, runs
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for case, shp in DIST_QUANT_CASES:
        r = quant_case(case, gen, shp)
        emit("kernel_vs_plain", path="dist_sync", **r)
        rows.append(r)
        torch.cuda.empty_cache()
    return launches, rows


def _dist_rank(rank: int, world: int, store: str, out: str, jobs: list) -> None:
    """One rank of the spawned dist runs, in a process of its own on
    ``cuda:rank``: each job ``(name, layers, global batch, plan keywords,
    kind)`` 3 steps, ``kind`` a manual kind (``ManualSync``, built directly
    at world one, where ``make_strategy`` would route the plan to
    ``XlaSync``) or ``"xla"`` (the sharded ``XlaSync``). Rank 0 writes
    them."""
    sys.path.insert(0, str(HERE / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import MemoryPlan
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M

    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                            world_size=world, device_id=device)
    try:
        mesh = make_local_mesh(device)
        res, params = {}, {}
        for name, layers, batch, kw, kind in jobs:
            if kw.get("act_policies") is not None:
                kw = {**kw, "act_policies": tuple(kw["act_policies"])}
            cfg = dataclasses.replace(get_config("mistral-7b"), num_layers=layers)
            if layers not in params:  # one draw a depth, shared by its jobs
                params = {layers: M.init_params(
                    cfg, torch.Generator(device=device).manual_seed(0), device)}
            xla = kind == "xla"
            r = dist_run(cfg, ShapeConfig(name, TRAIN_SEQ, batch, "train"), MemoryPlan(**kw),
                         params[layers], DIST_RANKS_STEPS, mesh=mesh,
                         kind=None if xla or world > 1 else kind, sharded=xla, warmup=1)
            assert r["strategy"] == kind and (r["sharded"] or not xla), (name, r["strategy"])
            check_dist_run(name, r, None)
            res[name] = r
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn_dist_ranks(world: int, jobs: list) -> dict:
    """``jobs`` (``_dist_rank``) on ``world`` spawned NCCL ranks, one a
    card: rank 0's runs by name."""
    import tempfile

    import torch.multiprocessing as mp

    d = tempfile.mkdtemp()
    try:
        mp.start_processes(_dist_rank, args=(world, f"{d}/store", f"{d}/out.json", jobs),
                           nprocs=world, join=True, start_method="spawn")
        with open(f"{d}/out.json") as f:
            return json.load(f)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _plan_kwargs(plan) -> dict:
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}


def phase_dist_ranks() -> dict[str, int]:
    """One NCCL rank per visible card, each its own process (the launcher's
    spawn), mistral-7b at full width, 2 layers, one row of S 4096 a rank:
    the three manual kinds, then ``dist_xla``'s two plans through the
    sharded ``XlaSync`` (in the same processes: one spawn, one warm-up),
    3 steps each (the median over the last 2: a fresh process's first step
    warms up). On a one-card machine this is a world of one, and says so.
    Returns rank 0's launches of the manual kinds, summed."""
    import torch

    world = torch.cuda.device_count()
    nc, nb = DIST_RANKS_LAYERS + 2, DIST_RANKS_LAYERS
    manual = dist_plans(nc, nb)
    xla = xla_plans(nc, nb)
    jobs = ([(k, nb, world, _plan_kwargs(manual[k]), k) for k in DIST_KINDS]
            + [(n, nb, world, _plan_kwargs(p), "xla") for n, p in xla.items()])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn_dist_ranks(world, jobs)
    launches: dict[str, int] = {}
    for name, r in res.items():
        emit("dist_xla_ranks" if name in xla else "dist_ranks", case=name, world=world,
             layers=nb, batch_per_rank=1, seq=TRAIN_SEQ, **r)
        if name not in xla:
            sum_launches(launches, r["launches"])
    note = ("ran at world 1: one card is visible; multi-card numbers wait for a machine "
            "with several cards") if world == 1 else f"ran at world {world}"
    emit("dist_ranks_world", world=world, note=note, seconds=time.perf_counter() - t0)
    return launches


# ---------------------------------------------------------------------------
# The xla path on several ranks (train/sync.XlaSync, sharded)
# ---------------------------------------------------------------------------
# the plan searched on 4 data ranks: mistral-7b at 32 layers, B 4 (one row a
# rank), S 4096; trained where 4 cards are visible
DIST_XLA_SEARCH_WORLD, DIST_XLA_SEARCH_BATCH = 4, 4


def xla_plans(nc: int, nb: int) -> dict:
    """The dist_xla phase's plans at ``nb`` layers (``nc = nb + 2``
    chunks). ``xla_host``: the front persistent, one ZeRO-sharded ``hbm``
    chunk, the last ``nb // 2 + 1`` chunks on the host (weights and states
    pinned), the first block swapped, the next ``nb // 2`` checkpointed,
    only the head buffered (host blocks are fetched again in the backward),
    int8 + EF. ``xla_zero``: the first ``nb // 2`` chunks persistent with
    their optimizer states sharded (``zero1_persistent``), the rest
    ZeRO-sharded in device memory, the last two buffered, no compression."""
    from repro_torch.core.plan import MemoryPlan

    n_host = nb // 2 + 1
    return {"xla_host": MemoryPlan(nc, nb, n_persist=nc - n_host - 1, n_host=n_host,
                                   n_buffer=1, n_swap=1, n_checkpoint=nb // 2,
                                   grad_compress="int8_ef"),
            "xla_zero": MemoryPlan(nc, nb, n_persist=nb // 2, n_buffer=2,
                                   zero1_persistent=True)}


def sum_launches(into: dict, launches: dict) -> None:
    for k, v in launches.items():
        into[k] = into.get(k, 0) + v


def phase_dist_xla_world_one() -> dict[str, int]:
    """mistral-7b at full width, ``DIST_LAYERS`` layers, B 2, S 4096, the
    weights of ``dist_sync``: each of ``xla_plans`` 3 timed steps (and one
    profiled) through the sharded ``XlaSync`` built directly over a
    one-rank NCCL group, then 3 through the single-device step
    (``make_strategy`` at world one) from the same weights; every
    collective at world one is a copy, so losses and fp32 masters must
    agree bitwise. Returns the sharded runs' launches, summed."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import LocalMesh, make_local_mesh
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("mistral-7b"), num_layers=DIST_LAYERS)
    shape = ShapeConfig("dist_xla", TRAIN_SEQ, DIST_BATCH, "train")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    store = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    launches: dict[str, int] = {}
    try:
        mesh = make_local_mesh("cuda:0")
        for name, plan in xla_plans(DIST_LAYERS + 2, DIST_LAYERS).items():
            r = dist_run(cfg, shape, plan, params, DIST_STEPS, mesh, sharded=True,
                         profile=True, keep_masters=True)
            assert r["strategy"] == "xla" and r["sharded"], (name, r["strategy"])
            check_dist_run(name, r, None)
            sum_launches(launches, r["launches"])
            ref = r.pop("_masters")
            single = dist_run(cfg, shape, plan, params, DIST_STEPS,
                              LocalMesh(0, 1, None, torch.device("cuda", 0)), ref_masters=ref)
            del ref
            assert single["sharded"] is False, name
            check_dist_run(f"{name}_single", single, None)
            emit("dist_xla", case=name, layers=DIST_LAYERS, batch=DIST_BATCH, seq=TRAIN_SEQ,
                 world=1, process_group="nccl, one rank (XlaSync sharded, built directly)",
                 **r)
            emit("dist_xla", case=f"{name}_single", against=name, bitwise=True, **single)
            assert single["losses"] == r["losses"], (name, single["losses"], r["losses"])
            assert single["masters"]["differ"] == 0, (name, single["masters"])
            assert single["masters"]["update_norm"] > 0, (name, single["masters"])
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    release_pinned_cache()
    return launches


def pinned_per_host(cfg, plan, world: int) -> dict:
    """What a plan's host chunks pin on one host of ``world`` ranks: each
    rank's shards of their leaves (a leaf whose ``zero`` dim the world does
    not divide whole), fp32 master, m and v, and the bf16 weights under
    ``host_params``; exact, and each allocation rounded up to a power of two
    as PyTorch's caching host allocator rounds it. Swap buffers aside."""
    from repro_torch.dist import sharding as SH
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.train.step_builder import plan_runs

    defs = M.param_defs(cfg)
    leaves = []  # (elements a rank, weight bytes an element)

    def collect(tree, length=None):
        def one(d):
            shape = d.shape if length is None else (length,) + d.shape[1:]
            dim = SH.leaf_sync_dim(dataclasses.replace(d, shape=shape), world, "host")
            leaves.append((math.prod(shape) // (world if dim is not None else 1),
                           L.torch_dtype(d.dtype).itemsize))
        L.map_defs(one, tree)

    if plan.chunk_placement(0) == "host":
        collect({k: defs[k] for k in ("embed", "encoder") if k in defs})
    if plan.chunk_placement(plan.n_chunks - 1) == "host":
        collect({k: defs[k] for k in ("final_norm", "head") if k in defs})
    for run in plan_runs(plan, M.num_repeats(cfg)):
        if run.placement == "host":
            collect(defs["blocks"], run.length)
    up = lambda n: 1 << (n - 1).bit_length() if n else 0  # noqa: E731
    w = plan.host_params
    exact = sum(12 * n + (b * n if w else 0) for n, b in leaves)
    rounded = sum(3 * up(4 * n) + (up(b * n) if w else 0) for n, b in leaves)
    return {"exact_bytes": world * exact, "rounded_bytes": world * rounded}


def phase_dist_xla(hw) -> dict[str, int]:
    """The xla path on several ranks: both ``xla_plans`` at world one
    against the single-device step (``phase_dist_xla_world_one``; their
    runs at ``DIST_RANKS_LAYERS`` layers on one spawned NCCL rank a visible
    card ran in ``phase_dist_ranks``'s processes); then the plan searched
    for mistral-7b at 32 layers, B 4, S 4096 on 4 data ranks against this
    machine's spec, with what it would pin on one host, trained 3 steps
    where 4 cards are visible. Returns the world-one sharded runs'
    launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.autotuner import search
    from repro_torch.core.cost_model import build_workload
    from repro_torch.core.hardware import MeshSpec

    launches = phase_dist_xla_world_one()
    world = torch.cuda.device_count()
    cfg = get_config("mistral-7b")
    shape = ShapeConfig("dist_xla_search", TRAIN_SEQ, DIST_XLA_SEARCH_BATCH, "train")
    w = build_workload(cfg, shape, MeshSpec((DIST_XLA_SEARCH_WORLD,), ("data",)), hw)
    res = search(w)
    plan = res.plan
    row = {"plan": plan.describe(), "world": DIST_XLA_SEARCH_WORLD, "layers": cfg.num_layers,
           "global_batch": DIST_XLA_SEARCH_BATCH, "seq": TRAIN_SEQ, "hw": hw.name,
           "feasible": res.feasible, "search_seconds": res.search_seconds,
           "modeled_t_iter_s": res.runtime.t_iteration, "modeled_peak_bytes": res.memory.peak,
           "pinned_per_host": pinned_per_host(cfg, plan, DIST_XLA_SEARCH_WORLD),
           "host_mem_bytes": hw.host_mem_bytes}
    if world >= DIST_XLA_SEARCH_WORLD:
        job = [("searched", cfg.num_layers, DIST_XLA_SEARCH_BATCH, _plan_kwargs(plan),
                plan.manual_sync_kind() if plan.sync_mode == "manual" else "xla")]
        run = spawn_dist_ranks(DIST_XLA_SEARCH_WORLD, job)["searched"]
        emit("dist_xla_search", ran=True, **row, run=run)
    else:
        emit("dist_xla_search", ran=False, **row,
             note=f"the plan needs {DIST_XLA_SEARCH_WORLD} cards; {world} visible: not run")
    return launches


# ---------------------------------------------------------------------------
# The model axis (dist/tensor_parallel.py)
# ---------------------------------------------------------------------------
# mistral-7b's 32 query over 8 KV heads of 128, split over a model extent
TP_FLASH_HEADS = ((2, (16, 4)), (4, (8, 2)))
TP_LAYERS, TP_STEPS, TP_MODEL = 2, 3, 2  # 8 layers in PR 26, 4 in PR 27
# tp_ranks against the single-device step: bf16 through 8 layers, the
# row-parallel products rounded twice (each rank's partial sum, then the
# reduced sum); train_compare's bounds, which hold kernels against the plain
# path through 2 layers
TP_LOSS_TOL, TP_NORM_RTOL = 1e-2, 2e-2
TP_SEQ_SHARD = (False, True)
# Adam's step of the other families' runs: at 3e-4 its first, sign-like
# updates turn bf16 rounding into diverging trajectories, and by step 3
# seamless-m4t-large-v2's grad norm (256k vocab) moved 0.04-0.6 % under
# mere re-chunkings of the one-device cross-entropy and 0.65-3.5 % on two
# ranks, by the chunking alone (scripts/tp_spread_chip.py, PERF.md §6);
# step 1 does not depend on it
TP_FAMILY_LR, TP_LR = 3e-5, 3e-4
# the families' depths on the model axis (widths stay whole), cut for the
# run's time: two ranks' steps on one card through gloo took 94 s of the
# phase's 134 at mistral-7b 8, qwen2-moe-a2.7b 1 (ZeRO over data), mamba2-130m
# 12, seamless 8 + 8 and llava 4 layers, and the script reached `done` at
# 809.9 s on an H100 (PERF.md §6); qwen2-moe's two resident states of one
# layer hold 19 GB each
TP_MOE_LAYERS, TP_MOE_BATCH = 1, 2
# (cut again when serve_mesh came: mamba2-130m 8 -> 4, seamless 4 + 4 -> 2 + 2)
TP_MAMBA_LAYERS, TP_MAMBA_SEQ = 4, 8192
TP_ENCDEC_LAYERS = 2
TP_VLM_LAYERS, TP_VLM_TOKENS = 2, 3072  # 1,024 patches ahead: P + S = 4,096
TP_VLM_SEQ = TP_VLM_TOKENS + VLM_PATCHES
# tp_ranks' runs, in order: (name, family, (pod, data, model), seq_shard_acts,
# plan): the resident plan, or "zero" (ZeRO-sharded hbm chunks, a persistent
# embedding chunk); "mistral_pod" puts the two ranks on two pods of one data
# rank each, its chunks sharded over the pod axis
TP_RUNS = (
    ("mistral", "mistral", (1, 1, TP_MODEL), False, "resident"),
    ("mistral_sp", "mistral", (1, 1, TP_MODEL), True, "resident"),
    ("moe_data", "moe", (1, TP_MODEL, 1), False, "resident"),
    ("mamba", "mamba", (1, 1, TP_MODEL), False, "resident"),
    ("mamba_sp", "mamba", (1, 1, TP_MODEL), True, "resident"),
    ("hybrid", "hybrid", (1, 1, TP_MODEL), False, "resident"),
    ("seamless", "seamless", (1, 1, TP_MODEL), False, "resident"),
    ("llava", "llava", (1, 1, TP_MODEL), False, "resident"),
    ("llava_sp", "llava", (1, 1, TP_MODEL), True, "resident"),
    ("mistral_pod", "mistral", (TP_MODEL, 1, 1), False, "zero"),
)
# the kernels each family's step must launch
TP_KERNELS = {"mamba": ("rmsnorm", "fused_adam"),
              "seamless": ("flash_attention", "flash_attention_bwd", "fused_adam")}
TP_DEFAULT_KERNELS = ("flash_attention", "flash_attention_bwd", "rmsnorm", "fused_adam")


def tp_family_flash() -> list[tuple]:
    """The other families' flash shapes at a model extent of 2: (family,
    heads, hd, query rows, key rows, causal). The hybrid's 8 over 1 of 128
    as 4 over 1; seamless-m4t-large-v2's 16 over 16 of 64 as 8 over 8 (the
    decoder's causal S 4096, the encoder's non-causal S 4096, a
    cross-attention's 1024 over 4096); llava-next-34b's 56 over 8 of 128
    as 28 over 4 at P + S = 4,096."""
    half = lambda h: (h[0] // TP_MODEL, max(1, h[1] // TP_MODEL))  # noqa: E731
    rows = [("hybrid", half(HYBRID_HEADS), HD, HYBRID_SEQ, HYBRID_SEQ, True)]
    rows += [("seamless", half(ENCDEC_HEADS), ENCDEC_HD, s, sk, c)
             for s, sk, c in ENCDEC_FLASH_CASES]
    return rows + [("llava", half(VLM_HEADS), HD, TP_VLM_SEQ, TP_VLM_SEQ, True)]


def phase_tp_kernels() -> list[dict]:
    """The flash forward and backward at the model axis's shard shapes:
    mistral-7b's at extents 2 and 4, the other families' at 2."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(9)
    cases = [(dict(heads=heads), dict(model_extent=tp, family="mistral"))
             for tp, heads in TP_FLASH_HEADS]
    cases += [(dict(heads=heads, hd=hd, window=0, causal=c, sk=sk, s=s),
               dict(model_extent=TP_MODEL, family=fam))
              for fam, heads, hd, s, sk, c in tp_family_flash()]
    rows = []
    for kw, tag in cases:
        for r in flash_case(kw.pop("s", TRAIN_SEQ), gen, True, **kw):
            r.update(tag)
            emit("kernel_vs_plain", path="tp", **r)
            rows.append(r)
        torch.cuda.empty_cache()
    return rows


def tp_setup(family: str, seq_shard: bool, plan_kind: str = "resident"):
    """(config, shape, plan) of a ``tp`` run: the family at full width and
    its depth above, the resident plan (or, ``"zero"``, every block's chunk
    and the head's ZeRO-sharded in HBM, at B 2: a row a rank);
    qwen2-moe-a2.7b at B 2, its config's capacity factor 1.25."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import MemoryPlan, fully_resident_plan
    from repro_torch.models.model import num_repeats

    seq, batch = TRAIN_SEQ, 1
    if family == "mistral":
        cfg = dataclasses.replace(get_config("mistral-7b"), num_layers=TP_LAYERS)
        if plan_kind == "zero":  # the pod run: a row for each of its ranks
            batch = TP_MODEL
    elif family == "moe":
        cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=TP_MOE_LAYERS)
        batch = TP_MOE_BATCH
    elif family == "mamba":
        cfg = dataclasses.replace(get_config(MAMBA_ARCH), num_layers=TP_MAMBA_LAYERS)
        seq = TP_MAMBA_SEQ
    elif family == "hybrid":
        cfg, seq = hybrid_config(), HYBRID_SEQ
    elif family == "seamless":
        cfg = dataclasses.replace(encdec_cut(), num_layers=TP_ENCDEC_LAYERS,
                                  encoder_layers=TP_ENCDEC_LAYERS)
    else:
        cfg = dataclasses.replace(get_config(VLM_ARCH), num_layers=TP_VLM_LAYERS)
        seq = TP_VLM_TOKENS
    n = num_repeats(cfg)
    plan = (MemoryPlan(n + 2, n, n_persist=1) if plan_kind == "zero"
            else fully_resident_plan(n + 2, n))
    return cfg, ShapeConfig("tp", seq, batch, "train"), dataclasses.replace(
        plan, seq_shard_acts=seq_shard)


@contextlib.contextmanager
def moe_drop_count(into: dict):
    """Count the (token, k) choices the MoE layers' capacity drops while
    the block runs, in ``into``: each expert keeps its first C choices, so
    a layer drops its per-expert counts beyond C."""
    import torch

    from repro_torch.models import moe as MOE

    apply = MOE.apply_moe

    def counting(params, x, cfg, tp=None, route=None):
        with torch.no_grad():
            t = x.shape[0] * x.shape[1]
            _, _, one_hot, _ = MOE._top_k_gating(x.reshape(t, -1).float() @ params["router"],
                                                cfg.moe.top_k)
            over = one_hot.sum(dim=(0, 1)) - MOE.expert_capacity(cfg, t)
            into["dropped"] = into.get("dropped", 0) + int(over.clamp_min(0).sum())
            into["choices"] = into.get("choices", 0) + t * cfg.moe.top_k
        return apply(params, x, cfg, tp=tp, route=route)

    MOE.apply_moe = counting
    try:
        yield
    finally:
        MOE.apply_moe = apply


def tp_steps(family: str = "mistral", seq_shard: bool = False, mesh=None,
             plan_kind: str = "resident") -> dict:
    """``TP_STEPS`` steps of ``family``'s ``tp`` run (Adam at ``TP_LR`` for
    mistral-7b, ``TP_FAMILY_LR`` for the others) from the weights of
    seed 0, on ``mesh`` (None: one device), ``seq_shard`` its
    ``seq_shard_acts``, under ``plan_kind`` (``tp_setup``): losses, norms,
    step seconds, the kernels' launches over the steps, the peak, this
    rank's state bytes (weights and fp32 master, m and v); on one device an
    MoE's first step counts the choices its capacity dropped."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.optim.adam import AdamConfig, tree_leaves
    from repro_torch.train.step_builder import build_train_step

    cfg, shape, plan = tp_setup(family, seq_shard, plan_kind)
    lr = TP_LR if family == "mistral" else TP_FAMILY_LR
    art = build_train_step(cfg, plan, "cuda", shape, mesh=mesh, adam=AdamConfig(lr=lr))
    state = art.init(torch.Generator(device="cuda").manual_seed(0))
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(
        [state["params"]] + [state["opt"][k] for k in ("master", "m", "v")]))
    pipe = SyntheticTokenPipeline(cfg, shape, seed=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, norms, secs, drops = [], [], [], {}
    for step in range(TP_STEPS):
        batch = pipe.next_sync()
        count = family == "moe" and mesh is None and step == 0
        t0 = time.perf_counter()
        with moe_drop_count(drops) if count else contextlib.nullcontext():
            state, m = art.fn(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        secs.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    out = {"losses": losses, "grad_norms": norms, "step_seconds": secs,
           "launches": dict(K.launch_counts()), "peak_bytes": torch.cuda.max_memory_allocated(),
           "state_bytes": state_bytes, "strategy": art.strategy.kind,
           "arch": cfg.name, "layers": cfg.num_layers, "seq": shape.seq_len, "lr": lr,
           "batch": shape.global_batch, "plan": plan.describe(),
           "model_split_leaves": sum(ls.mdim is not None for ls in art.leaf_syncs),
           "data_split_leaves": sum(ls.dim is not None for ls in art.leaf_syncs)}
    if drops:
        out["moe_dropped_share"] = drops["dropped"] / drops["choices"]
        out["moe_choices"] = drops["choices"]
    del state, art
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of ``tp_ranks``: a process of its own on ``cuda:0``, in a
    gloo group of ``world``, running ``TP_RUNS`` in order on their (pod,
    data, model) layouts. Rank 0 writes its runs."""
    sys.path.insert(0, str(HERE / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    torch.cuda.set_device(0)
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        meshes = {lay: make_local_mesh("cuda:0", model=lay[2], pod=lay[0])
                  for lay in dict.fromkeys(r[2] for r in TP_RUNS)}
        runs = {name: tp_steps(family, sp, meshes[layout], kind)
                for name, family, layout, sp, kind in TP_RUNS}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(runs, f)
    finally:
        dist.destroy_process_group()


def phase_tp() -> tuple[dict[str, int], list[dict], dict[str, int]]:
    """The model axis on the card: the flash kernels at its shard shapes,
    then ``TP_MODEL`` ranks on the one card against the single-device step
    from the same weights, every family's run after the one-device
    reference of each has run and freed the card. Returns rank 0's
    launches, the flash rows and rank 0's launches over the pod axis."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    rows = phase_tp_kernels()
    t0 = time.perf_counter()
    one = {(fam, kind): tp_steps(fam, plan_kind=kind)
           for fam, kind in dict.fromkeys((r[1], r[4]) for r in TP_RUNS)}
    emit("tp_one_device_seconds", seconds=time.perf_counter() - t0)
    d = tempfile.mkdtemp()
    try:
        mp.start_processes(_tp_rank, args=(TP_MODEL, f"{d}/store", f"{d}/out.json"),
                           nprocs=TP_MODEL, join=True, start_method="spawn")
        with open(f"{d}/out.json") as f:
            runs = json.load(f)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    launches: dict[str, int] = {}
    pod_launches: dict[str, int] = {}  # the pod axis's run, a path of its own
    failed: list[str] = []
    for name, family, (pod, data, model), sp, kind in TP_RUNS:
        run, ref = runs[name], one[family, kind]
        loss_diff = [abs(a - b) for a, b in zip(run["losses"], ref["losses"])]
        norm_rel = [abs(a - b) / b for a, b in zip(run["grad_norms"], ref["grad_norms"])]
        line = "tp_pod" if pod > 1 else "tp_ranks" if family == "mistral" else (
            "tp_moe_data" if family == "moe" else "tp_families")
        extra = {k: ref[k] for k in ("moe_dropped_share", "moe_choices") if k in ref}
        emit(line, run=name, arch=run["arch"], layers=run["layers"], seq=run["seq"],
             batch=run["batch"], lr=run["lr"],
             layout={"pod": pod, "data": data, "model": model},
             backend="gloo", plan=run["plan"], seq_shard_acts=sp,
             losses=run["losses"], losses_one_device=ref["losses"],
             grad_norms=run["grad_norms"], grad_norms_one_device=ref["grad_norms"],
             loss_abs_diff=loss_diff, grad_norm_rel_diff=norm_rel,
             tol={"loss": TP_LOSS_TOL, "grad_norm_rel": TP_NORM_RTOL},
             strategy=run["strategy"], model_split_leaves=run["model_split_leaves"],
             data_split_leaves=run["data_split_leaves"],
             launches=run["launches"],
             peak_bytes_rank0=run["peak_bytes"], peak_bytes_one_device=ref["peak_bytes"],
             state_bytes_rank0=run["state_bytes"], state_bytes_one_device=ref["state_bytes"],
             **extra)
        emit("tp_step_seconds", run=name, seq_shard_acts=sp,
             not_tp_speed="two ranks share one card's SMs and gloo reduces through the host: "
             "these are no tensor-parallel step times",
             ranks=run["step_seconds"], one_device=ref["step_seconds"])
        checks = {"strategy xla": run["strategy"] == "xla",
                  "leaves split": model == 1 or run["model_split_leaves"] > 0,
                  "chunks sharded over the pods": pod == 1 or run["data_split_leaves"] > 0,
                  "finite": all(math.isfinite(x) for x in run["losses"] + run["grad_norms"]),
                  "losses within TP_LOSS_TOL": max(loss_diff) <= TP_LOSS_TOL,
                  "grad norms within TP_NORM_RTOL": max(norm_rel) <= TP_NORM_RTOL}
        checks.update({f"{k} launched": run["launches"].get(k, 0) > 0
                       for k in TP_KERNELS.get(family, TP_DEFAULT_KERNELS)})
        failed += [f"{name}: {k}" for k, ok in checks.items() if not ok]
        sum_launches(pod_launches if pod > 1 else launches, run["launches"])
    if not one["moe", "resident"]["moe_dropped_share"] > 0:
        failed.append("moe_data: the capacity dropped nothing")
    emit("tp_ranks_seconds", seconds=time.perf_counter() - t0)
    assert not failed, failed  # every run's line printed first
    torch.cuda.empty_cache()
    return launches, rows, pod_launches


# ---------------------------------------------------------------------------
# Serving on a mesh (train/step_builder.serve_layout, DecodeEngine(mesh=...))
# ---------------------------------------------------------------------------
# the paged kernel at the shards' heads over a model extent of 2: mistral-7b's
# 32 over 8 as 16 over 4 (group 4), llava-next-34b's 56 over 8 as 28 over 4
# (group 7), each pinned and on the device
SERVE_MESH_PAGED_HEADS = (((HQ // 2, HKV // 2), "mistral-7b"),
                          ((VLM_HEADS[0] // 2, VLM_HEADS[1] // 2), VLM_ARCH))
# teacher-forced logits of the ranks against one device's from the same
# weights and tokens, |diff| <= SERVE_MESH_TOL * (1 + max |logit|): bf16
# through the served layers, the row-parallel products summed in another
# order than on one device. On an H100 80GB HBM3 at 700 W the sound runs
# gave at most 0.0201 of (1 + max |logit|) (mesh_mamba; mesh_paged 0.0129,
# mesh_sharded 0) and the planted faults at least 1.06 (ssd_head; kv_group
# 1.25): the bound sits 2.5x above the one and 21x below the other
SERVE_MESH_TOL = 5e-2
# teacher forcing: 8 seeded tokens a slot on the cache the engine's run
# filled, from the shortest prompt's length: every slot's rows before it
# are its prompt's, the same on both sides, and a paged cache holds most of
# them cold; an attention-free model's state starts fresh
SERVE_MESH_TEACHER_STEPS = 8
# planted split faults, each run on the ranks after the sound pass, its gap
# printed beside the sound one; the phase fails unless it exceeds the bound.
# "kv_group": each attention layer's query heads rolled by one KV group
# within the rank's shard (wq's columns, wo's rows), so they read their
# neighbours' KV head; "ssd_head": each Mamba-2 layer's SSD heads rolled by
# one head in the rank's rows of out_proj. (A doubled reduction of every
# partial sum is a weak test: it scales most of the residual stream, which
# the pre-norms largely cancel.)
SERVE_MESH_FAULTS = {"mesh_paged": "kv_group", "mesh_mamba": "ssd_head"}
# the runs, in order: (name, arch, (data, model), plan, admission, layers,
# prompt lengths, new tokens). Depths cut for the run's time (two processes'
# eager steps on one card through gloo). mesh_sharded also cuts the traffic:
# the chunked prefill runs the step once a prompt token, and under
# n_persist = 0 every step gathers the layer, the embedding and the head
# (half of them from the other rank, through the host): 1.3 s a step at 2
# layers on an H100 80GB HBM3 at 700 W, so 800-token prompts would take
# about 1000 s; it serves 1 layer, prompts of 8-15 tokens and 4 new
SERVE_MESH_RUNS = (
    ("mesh_paged", "mistral-7b", (1, 2), "paged", "chunked", 8, PROMPT_LENS, NEW_TOKENS),
    ("mesh_sharded", "mistral-7b", (2, 1), "sharded", "chunked", 1, (8, 16), 4),
    ("mesh_mamba", MAMBA_ARCH, (1, 2), "resident", "replay", 12, (24, 40), NEW_TOKENS),
)
SERVE_MESH_NOTE = ("two processes share one card's SMs and gloo reduces through the host: "
                   "no serving speed at a model or data extent above one")


def phase_serve_mesh_kernels() -> list[dict]:
    """The paged kernel ``main`` at the shards' heads (``SERVE_MESH_PAGED_HEADS``),
    cold store pinned and on the device, against its plain version, the
    bound and SDPA."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = []
    for heads, arch in SERVE_MESH_PAGED_HEADS:
        for host in (True, False):
            r = {"kernel": "paged_attention", **paged_case("main", host, gen, heads, arch),
                 "model_extent": 2, "family": arch}
            emit("kernel_vs_plain", path="serve_mesh", **r)
            rows.append(r)
        torch.cuda.empty_cache()
    return rows


def serve_mesh_setup(run: tuple):
    """(config, shape, plan, paging, engine keywords, requests' prompts) of
    a ``SERVE_MESH_RUNS`` run."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import MemoryPlan
    from repro_torch.models import kvcache as KV
    from repro_torch.models.model import num_repeats
    from repro_torch.serve import choose_paging

    _, arch, _, kind, admission, layers, lens, _ = run
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    n = num_repeats(cfg)
    paging = None
    plan = MemoryPlan(n + 2, n, n_persist=0 if kind == "sharded" else n + 2)
    if kind == "paged":
        paging = choose_paging(KV.cache_len(cfg, SEQ_LEN), PAGE, N_HOT)
        plan = MemoryPlan(n + 2, n, n_persist=n + 2, n_host=paging.n_cold)
    kw = dict(admission=admission)
    if admission != "replay":
        kw["prefill_chunk"] = PREFILL_CHUNK
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, int(k)).tolist()
               for k in rng.integers(*lens, size=BATCH)]
    return cfg, ShapeConfig("serve_mesh", SEQ_LEN, BATCH, "decode"), plan, paging, kw, prompts


def filled_cache(engine, cfg, prompts: list, finished: dict) -> dict:
    """The engine's cache as its run left it, as a resident tree on the
    card (a copy): a paged cache's cold store with the rows its hot ring
    holds canonically (``PagedKV.residency`` at each slot's next write).
    Requests took the slots in order, so slot b served request b."""
    import torch

    from repro_torch.serve import PagedKV

    cache, spec = engine.state["cache"], engine.paging
    if spec is None:
        return {p: {k: t.clone() for k, t in e.items()} for p, e in cache.items()}
    dev = next(iter(cache.values()))["k_hot"].device
    nxt = torch.tensor([len(prompts[b]) + len(finished[b]) - 1 for b in range(BATCH)])
    sel = PagedKV(spec).residency(nxt[engine.layout.rows].to(dev), bool(cfg.sliding_window))
    ring = torch.arange(spec.cache_len, device=dev) % spec.hot_window
    return {p: {x: torch.where(sel[None, :, :, None, None], e[f"{x}_hot"][:, :, ring],
                               e[f"{x}_cold"].to(dev)) for x in ("k", "v")}
            for p, e in cache.items()}


def planted_fault(params: dict, cfg, fault: str) -> dict:
    """``params`` with a planted split fault (``SERVE_MESH_FAULTS``) in
    this rank's shards: ``kv_group`` rolls each attention layer's query
    heads by one KV group (wq's columns, wo's rows), ``ssd_head`` each
    Mamba-2 layer's heads by one head in ``out_proj``'s rows."""
    import torch

    if fault == "kv_group":
        sub, rolls = "attn", {"wq": (cfg.num_heads // cfg.num_kv_heads
                                     * cfg.resolved_head_dim, -1)}
        rolls["wo"] = (rolls["wq"][0], -2)
    else:
        sub, rolls = "mamba", {"out_proj": (cfg.mamba2.head_dim, -2)}
    blocks = {}
    for pos, bp in params["blocks"].items():
        if sub in bp:
            bp = {**bp, sub: {**bp[sub], **{k: torch.roll(bp[sub][k], n, d)
                                           for k, (n, d) in rolls.items()}}}
        blocks[pos] = bp
    return {**params, "blocks": blocks}


def teacher_logits(engine, cfg, prompts: list, finished: dict, fault: str | None = None):
    """``SERVE_MESH_TEACHER_STEPS`` decode steps of seeded tokens through
    the engine's weights and layout: on the cache its run filled
    (``filled_cache``), from the shortest prompt's length, through the
    resident decode; an attention-free model on a fresh state. Each step's
    logits made whole over the vocab and the slots: (steps, B, V) fp32 on
    the host. ``fault``: a planted split fault (``SERVE_MESH_FAULTS``)."""
    import numpy as np
    import torch

    from repro_torch.dist.tensor_parallel import gather_vocab
    from repro_torch.models import kvcache as KV

    lay, params = engine.layout, engine.state["params"]
    rows, n = lay.rows, lay.slots[1]
    dev = engine.device
    if cfg.attention_free:
        cache, start = KV.init_cache(cfg, n, SEQ_LEN, dev, lay.tp), 0
    else:
        cache = filled_cache(engine, cfg, prompts, finished)
        start = min(len(p) for p in prompts)
    if fault is not None:
        params = planted_fault(params, cfg, fault)
    toks = np.random.default_rng(1).integers(1, cfg.vocab_size,
                                             (BATCH, SERVE_MESH_TEACHER_STEPS))
    gather = lay.gather(params)
    outs = []
    with torch.inference_mode():
        for t in range(SERVE_MESH_TEACHER_STEPS):
            logits, _ = KV.decode_step(params, cache,
                                       torch.from_numpy(toks[rows, t:t + 1]).to(dev),
                                       torch.full((n,), start + t), cfg, tp=lay.tp,
                                       route=lay.route, gather=gather)
            outs.append(lay.gather_rows(gather_vocab(logits, lay.tp, cfg.vocab_size)).float())
    return torch.stack(outs).cpu()


def serve_mesh_serve(run: tuple, mesh=None) -> dict:
    """A ``SERVE_MESH_RUNS`` run on ``mesh`` (None: one device, its graph
    engine): ``DecodeEngine`` from seed 0's weights over the run's requests,
    then the teacher-forced logits (``teacher_logits``). Returns the
    report, the tokens, rank 0's launches and step replays over the served
    run, the peak, the cache and cold-read bytes, the logits."""
    import torch

    from repro_torch import kernels as K
    from repro_torch import obs
    from repro_torch.models.model import init_params
    from repro_torch.serve import DecodeEngine, Request

    cfg, shape, plan, paging, kw, prompts = serve_mesh_setup(run)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    engine = DecodeEngine(cfg, plan, None if mesh else "cuda", shape, params, paging=paging,
                          own_params=True, telemetry=obs.Telemetry(trace=False), mesh=mesh,
                          **kw)
    del params  # a rank keeps its shards: the peak below is the serving one
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine.warmup()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    engine.serve_step.replays = 0
    report = engine.run([Request(i, p, run[7]) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    launches = {k: K.launch_counts()[k] for k in SERVING_KERNELS}
    replays = engine.serve_step.replays
    teacher = teacher_logits(engine, cfg, prompts, report.finished)
    fault = SERVE_MESH_FAULTS.get(run[0]) if mesh is not None else None
    faulty = None if fault is None else teacher_logits(engine, cfg, prompts, report.finished,
                                                       fault)
    out = {"report": report.to_dict(), "finished": {str(k): v for k, v in report.finished.items()},
           "launches": launches, "replays": replays, "peak_bytes": torch.cuda.max_memory_allocated(),
           "hbm_cache_bytes": report.hbm_cache_bytes, "host_cache_bytes": report.host_cache_bytes,
           "h2d_bytes": report.h2d_bytes,
           "graph": engine.serve_step.graph is not None, "slots": list(engine.layout.slots),
           "gathers": sum(v["value"] for k, v in engine.tel.registry.snapshot().items()
                          if k.startswith("sync.param_gathers")),
           "teacher": teacher, "fault": fault, "faulty": faulty}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    release_pinned_cache()
    return out


def _serve_mesh_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of ``serve_mesh``: a process of its own on ``cuda:0``, in a
    gloo group of ``world``, serving ``SERVE_MESH_RUNS`` in order on their
    layouts. Rank 0 writes its runs (``torch.save``)."""
    sys.path.insert(0, str(HERE / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        meshes = {m: make_local_mesh("cuda:0", model=m) for m in (1, world)}
        runs = {}
        for run in SERVE_MESH_RUNS:
            t0 = time.perf_counter()
            runs[run[0]] = serve_mesh_serve(run, meshes[run[2][1]])
            runs[run[0]]["seconds"] = time.perf_counter() - t0
        if rank == 0:
            torch.save(runs, out)
    finally:
        dist.destroy_process_group()


def phase_serve_mesh() -> tuple[dict[str, int], list[dict]]:
    """Serving on a mesh on the card: the paged kernel at the shards' heads,
    then each ``SERVE_MESH_RUNS`` run on one device (its graph engine) and
    on two gloo ranks sharing ``cuda:0`` (NCCL refuses two ranks on one
    card), from the same weights: the ranks' teacher-forced logits within
    ``SERVE_MESH_TOL`` of one device's, rank 0's ``paged_attention`` and
    ``rmsnorm`` launches equal to the plan's count (a paged attention an
    attention layer and ``decode_norms`` a step, for every step replayed),
    and how many greedy tokens equal one device's. Returns rank 0's
    launches and the kernel rows."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    rows = phase_serve_mesh_kernels()
    t0 = time.perf_counter()
    one = {run[0]: serve_mesh_serve(run) for run in SERVE_MESH_RUNS}
    emit("serve_mesh_one_device_seconds", seconds=time.perf_counter() - t0)
    d = tempfile.mkdtemp()
    try:
        mp.start_processes(_serve_mesh_rank, args=(2, f"{d}/store", f"{d}/out.pt"),
                           nprocs=2, join=True, start_method="spawn")
        ranks = torch.load(f"{d}/out.pt", weights_only=False)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    launches: dict[str, int] = {}
    failed: list[str] = []
    for run in SERVE_MESH_RUNS:
        name, arch, (data, model), kind = run[:4]
        got, ref = ranks[name], one[name]
        cfg, *_, prompts = serve_mesh_setup(run)
        gap = (got["teacher"] - ref["teacher"]).abs().max().item()
        scale = ref["teacher"].abs().max().item()
        tol = SERVE_MESH_TOL * (1 + scale)
        fault_gap = (None if got["faulty"] is None else
                     (got["faulty"] - ref["teacher"]).abs().max().item())
        same = sum(a == b for rid, toks in ref["finished"].items()
                   for a, b in zip(toks, got["finished"][rid]))
        total = sum(len(t) for t in ref["finished"].values())
        n_attn = sum(cfg.mixer_at(i) == "attention" for i in range(cfg.num_layers))
        want = {"paged_attention": got["replays"] * n_attn if kind == "paged" else 0,
                "rmsnorm": got["replays"] * decode_norms(cfg)}
        rep, rep1 = got["report"], ref["report"]
        emit("serve_mesh", run=name, arch=arch, layers=cfg.num_layers, d_model=cfg.d_model,
             layout={"data": data, "model": model}, plan=kind, backend="gloo",
             admission=rep["admission"], prompt_lens=list(run[6]), new_tokens=run[7],
             not_serving_speed=SERVE_MESH_NOTE,
             tokens_per_s=rep["tokens_per_s"], p50_ttft_s=rep["p50_ttft_s"],
             tokens_per_s_one_device=rep1["tokens_per_s"],
             p50_ttft_s_one_device=rep1["p50_ttft_s"], graph_one_device=ref["graph"],
             peak_bytes_rank0=got["peak_bytes"], peak_bytes_one_device=ref["peak_bytes"],
             hbm_cache_bytes_rank0=got["hbm_cache_bytes"],
             hbm_cache_bytes_ranks=rep.get("hbm_cache_bytes_ranks"),
             hbm_cache_bytes_one_device=ref["hbm_cache_bytes"],
             host_cache_bytes_rank0=got["host_cache_bytes"],
             host_cache_bytes_one_device=ref["host_cache_bytes"],
             h2d_bytes_rank0=got["h2d_bytes"], h2d_bytes_ranks=rep.get("h2d_bytes_ranks"),
             h2d_bytes_one_device=ref["h2d_bytes"], slots_rank0=got["slots"],
             weight_gathers_rank0=got["gathers"], replays=got["replays"],
             launches=got["launches"], launches_plan=want,
             teacher_forced={"max_abs_diff": gap, "max_abs_logit": scale, "tol": tol,
                             "tol_text": f"{SERVE_MESH_TOL} * (1 + max |logit|)",
                             "steps": SERVE_MESH_TEACHER_STEPS,
                             "from": 0 if cfg.attention_free else min(map(len, prompts)),
                             "cache": "fresh" if cfg.attention_free else "filled by the run",
                             "planted_fault": got["fault"], "fault_max_abs_diff": fault_gap},
             greedy_equal=same, greedy_total=total, seconds=got["seconds"])
        checks = {"drained": rep["drained"] and rep1["drained"],
                  "launches equal the plan's": got["launches"] == want,
                  "teacher-forced within SERVE_MESH_TOL": gap <= tol,
                  "the planted fault beyond it": fault_gap is None or fault_gap > tol,
                  "weights gathered": (got["gathers"] > 0) == (kind == "sharded")}
        failed += [f"{name}: {k}" for k, ok in checks.items() if not ok]
        sum_launches(launches, got["launches"])
    emit("serve_mesh_seconds", seconds=time.perf_counter() - t0)
    assert not failed, failed  # every run's line printed first
    torch.cuda.empty_cache()
    return launches, rows


def run_launcher(module, argv: list[str]) -> dict:
    """``module.main(argv)`` in this process, its standard output echoed and
    its last line read as the launcher's JSON summary; the kernels' launch
    counts zeroed just before."""
    import io

    import torch

    from repro_torch import kernels as K

    buf = io.StringIO()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    print(out, end="", flush=True)
    assert rc == 0, f"{module.__name__} {argv} exited {rc}"
    summary = json.loads(out.strip().splitlines()[-1])
    gc.collect()
    torch.cuda.empty_cache()
    release_pinned_cache()
    return {"argv": argv, "summary": summary, "launches": dict(K.launch_counts()),
            "seconds": seconds}


LAUNCHER_RUNS = (  # (name, launcher, argv)
    ("train_mistral", "train", ["--arch", "mistral-7b", "--steps", "2", "--batch", "1",
                                "--seq", str(TRAIN_SEQ)]),
    ("serve_mistral", "serve", ["--arch", "mistral-7b", "--plan", "paged"]),
    ("train_seamless", "train", ["--arch", ENCDEC_ARCH, "--steps", "2", "--batch", "1",
                                 "--seq", str(TRAIN_SEQ)]),
)


def phase_launchers() -> dict[str, dict[str, int]]:
    """Both launchers through their ``main(argv)`` on the card, as a user
    runs them: ``launch.train`` on mistral-7b at full depth (the searched
    plan, as searched) and on seamless-m4t-large-v2, each 2 steps of B 1 at
    S 4096, with finite losses; ``launch.serve`` on mistral-7b's paged plan
    and its default request stream, drained. Returns each run's launches."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    mods = {"train": launch_train, "serve": launch_serve}
    # what the plan phases' pinned states left in the caching host allocator
    emit("launchers_host_cache", **release_pinned_cache(), host=host_memory())
    out = {}
    for name, which, argv in LAUNCHER_RUNS:
        r = run_launcher(mods[which], argv)
        emit("launcher", name=name, **r)
        summary = r["summary"]
        if which == "train":
            assert summary["steps"] == 2 and summary["device"].startswith("cuda"), summary
            assert all(math.isfinite(summary[k]) for k in ("first_loss", "final_loss")), summary
            for k in ("flash_attention", "flash_attention_bwd", "fused_adam"):
                assert r["launches"][k] > 0, f"{name}: {k} was not launched"
        else:
            assert summary["drained"] and summary["device"].startswith("cuda"), summary
            assert r["launches"]["paged_attention"] > 0, f"{name}: paged_attention not launched"
        out[name] = r["launches"]
    return out


# ---------------------------------------------------------------------------
# The dry-run (launch/dryrun.py): every production cell planned on
# H100_SXM's data sheet and built on fake tensors for rank 0 of the 256- and
# 512-card meshes; the fake builds of the train and engine phases' own
# steps against the peaks the card measured. It runs after the card's
# phases, with nothing beside it
# ---------------------------------------------------------------------------
DRYRUN_MESHES = ("single", "multi")
# the sweep's processes, a host core each beside the main process, which waits
DRYRUN_WORKERS = 7
# the most the sweep's processes may take together
DRYRUN_TIMEOUT_S = 420
# the card's peak over the dry-run's (argument + live bytes on the kernel
# route), written in PERF.md before the first call that held it
DRYRUN_VS_CARD_BOUND = (0.9, 1.15)


def dryrun_tasks() -> list[tuple[str, ...]]:
    """What the sweep's processes share, in the order they take it: the
    fake builds of the card phases' own steps (``fake_vs_card``), the
    MegaTrain demo, then every cell of both meshes, training first and the
    largest models first, so that the longest builds start first."""
    from repro_torch.configs import ARCHS, get_config, get_shape
    from repro_torch.launch.dryrun import cells

    first = {"train": 0, "prefill": 1, "decode": 2}
    todo = [(arch, shape, mesh) for arch, shape in cells(sorted(ARCHS))
            for mesh in DRYRUN_MESHES]
    todo.sort(key=lambda c: (first[get_shape(c[1]).mode], -get_config(c[0]).param_count()))
    return [("vs_card",), ("megatrain",)] + todo


def dryrun_worker(out: str, index: str) -> None:
    """A process of the sweep (``phase_dryrun``), on the kernel route: it
    takes the next task of ``dryrun_tasks`` that no other process has
    claimed (a file made with ``O_EXCL`` under ``out/claims``) until none
    is left. Autograd on fake CUDA tensors needs a CUDA context, so each
    process holds one: torch's fake mode makes it at the first fake CUDA
    tensor with one real 4-byte tensor, freed at once
    (``init_gpu_context``), which the process makes before its first task.
    After each task it writes to ``out/tasks_<index>.jsonl`` the kernels
    that task launched and the most it allocated on the card, both to be
    0."""
    import os

    import torch

    from repro_torch import kernels as K
    from repro_torch.launch import dryrun as D

    from torch._subclasses.fake_tensor import FakeTensorMode

    torch.set_num_threads(1)
    with FakeTensorMode():
        torch.empty(1, device="cuda")  # the CUDA context, before any task
    os.makedirs(f"{out}/claims", exist_ok=True)
    for task in dryrun_tasks():
        try:
            os.close(os.open(f"{out}/claims/{'.'.join(task)}", os.O_CREAT | os.O_EXCL))
        except FileExistsError:
            continue
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if task == ("vs_card",):
            fake_vs_card(f"{out}/vs_card.json")
            rc = 0
        elif task == ("megatrain",):
            try:
                rc = D.main(["--megatrain", "--device", "cuda", "--out", f"{out}/megatrain"])
            except AssertionError as e:  # the plan overflows the card: the reference's message
                print(f"[dryrun] MEGATRAIN {e}", flush=True)
                rc = str(e)
        else:
            arch, shape, mesh = task
            rc = D.main(["--arch", arch, "--shape", shape, "--mesh", mesh,
                         "--device", "cuda", "--out", f"{out}/w{index}"])
        with open(f"{out}/tasks_{index}.jsonl", "a") as f:
            f.write(json.dumps({"task": list(task), "rc": rc,
                                "seconds": time.perf_counter() - t0,
                                "launches": sum(K.launch_counts().values()),
                                "max_allocated": torch.cuda.max_memory_allocated()}) + "\n")


def fake_vs_card(path: str) -> None:
    """The dry-run's fake builds of the ``train`` phase's step (its config,
    shape and plan, world one) and of the ``engine`` phase's decode step
    (mistral-7b, its paging, a chunk of ``PREFILL_CHUNK``), on the kernel
    route, with the train plan's analytic FLOPs a step; written to ``path``
    as JSON."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import build_workload, step_totals
    from repro_torch.core.hardware import H100_SXM, ONE_CHIP
    from repro_torch.launch import dryrun as D

    cuda = torch.device("cuda")
    out = {}
    cfg, shape, plan = train_setup()
    got = D.fake_step(cfg, shape, plan, ONE_CHIP, cuda)
    out["train"] = {k: got[k] for k in ("memory", "counted_flops", "kernel_flops", "run_s")}
    out["train"]["analytic_flops"] = step_totals(build_workload(cfg, shape, ONE_CHIP, H100_SXM),
                                                 plan)[0]
    cfg = get_config("mistral-7b")
    shape, spec, plan, _ = serve_setup(cfg)
    got = D.fake_step(cfg, shape, plan, ONE_CHIP, cuda, paging=spec, chunk=PREFILL_CHUNK)
    out["engine"] = {k: got[k] for k in ("memory", "counted_flops", "kernel_flops", "run_s")}
    with open(path, "w") as f:
        json.dump(out, f)


def _tail(path: str, n: int = 2000) -> str:
    with open(path) as f:
        return f.read()[-n:]


def _jsonl(paths) -> list[dict]:
    return [json.loads(line) for p in sorted(paths) for line in open(p)]


def phase_dryrun(out: str) -> dict:
    """The sweep in ``DRYRUN_WORKERS`` processes (``dryrun_worker``) after
    the card's phases; one line a cell (plan, bottleneck, the three terms,
    the built step's temp and peak bytes beside the modeled peak); each
    mode's count, the failures, the seconds, the MegaTrain demo. Fails
    unless all 66 cells are ``ok`` and no task launched a kernel or
    allocated on the card. Returns the fake builds of the card phases'
    steps (``fake_vs_card``)."""
    import os

    env = {**os.environ, "PYTHONPATH": str(HERE / "src"), "OMP_NUM_THREADS": "1"}
    t0 = time.perf_counter()
    procs = []
    try:
        for i in range(DRYRUN_WORKERS):
            log = open(f"{out}/w{i}.log", "w")
            procs.append((subprocess.Popen([sys.executable, str(HERE / "chip_smoke.py"),
                                            "--dryrun-worker", out, str(i)],
                                           stdout=log, stderr=subprocess.STDOUT, env=env,
                                           cwd=HERE), log))
        for i, (proc, _) in enumerate(procs):
            rc = proc.wait(timeout=max(1.0, t0 + DRYRUN_TIMEOUT_S - time.perf_counter()))
            if rc != 0:
                print(_tail(f"{out}/w{i}.log", 6000), file=sys.stderr)
            assert rc == 0, f"the dry-run's process {i}: {rc}"
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    wall = time.perf_counter() - t0
    tasks = _jsonl(pathlib.Path(out).glob("tasks_*.jsonl"))
    assert sorted(tuple(t["task"]) for t in tasks) == sorted(dryrun_tasks()), "tasks lost"
    card = {"launches": sum(t["launches"] for t in tasks),
            "max_allocated": max(t["max_allocated"] for t in tasks),
            "tasks": [t for t in tasks if t["launches"] or t["max_allocated"]]}
    recs = _jsonl(pathlib.Path(out).glob("w*/dryrun_cells_torch.jsonl"))
    for r in recs:
        if not r["ok"]:
            emit("dryrun_cell", arch=r["arch"], shape=r["shape"], mesh=r["mesh"], ok=False,
                 error=r["error"], trace=r["trace"][-600:])
            continue
        modeled = r["modeled"].get("peak_gb_per_chip", r["modeled"].get("peak_gb"))
        rl = r["roofline"]
        emit("dryrun_cell", arch=r["arch"], shape=r["shape"], mesh=r["mesh"], ok=True,
             plan=r["plan"], bottleneck=rl["bottleneck"], t_compute_s=rl["t_compute_s"],
             t_memory_s=rl["t_memory_s"], t_collective_s=rl["t_collective_s"],
             temp_gb=r["memory"]["temp_gb"], argument_gb=r["memory"]["argument_gb"],
             host_gb=r["memory"]["host_gb"], peak_gb=r["peak_gb"], modeled_peak_gb=modeled,
             counted_flops=rl["counted_flops"], flops_per_chip=rl["flops_per_chip"],
             n_collectives=r["n_collectives"], build_s=r["build_s"], run_s=r["run_s"])
    modes: dict[str, int] = {}
    for r in recs:
        if r["ok"]:
            modes[r["mode"]] = modes.get(r["mode"], 0) + 1
    failures = sum(not r["ok"] for r in recs)
    mega_rc = next(t["rc"] for t in tasks if t["task"] == ["megatrain"])
    if mega_rc == 0:
        with open(f"{out}/megatrain/dryrun_cells_torch.jsonl") as f:
            rec = json.loads(f.readline())
        mega = {"ok": rec["ok"], "plan": rec["plan"], **rec["megatrain"],
                "memory": rec["memory"], "bottleneck": rec["roofline"]["bottleneck"],
                "build_s": rec["build_s"], "run_s": rec["run_s"]}
    else:
        mega = {"ok": False, "assertion": mega_rc}
    emit("dryrun", cells=len(recs), by_mode=modes, failures=failures,
         route="kernels (fake CUDA tensors)", target_hw="h100-sxm",
         meshes={"single": [16, 16], "multi": [2, 16, 16]}, workers=DRYRUN_WORKERS,
         seconds=wall, cell_seconds=sum(r.get("build_s", 0) + r.get("run_s", 0) for r in recs),
         task_seconds=sum(t["seconds"] for t in tasks), card=card, megatrain=mega,
         note="every number priced on the data sheet: modeled, not measured")
    assert all(t["rc"] == 0 for t in tasks if t["task"] != ["megatrain"]), tasks
    assert failures == 0 and len(recs) == 66, (len(recs), failures)
    assert not card["tasks"], card
    assert mega["ok"] or "overflows the chip" in mega["assertion"], mega
    with open(f"{out}/vs_card.json") as f:
        return json.load(f)


def phase_dryrun_vs_card(fake: dict, train_run: dict, engine_record: dict) -> None:
    """The dry-run's peak (argument + temp bytes) of the ``train`` and
    ``engine`` phases' own steps (``fake``, from ``fake_vs_card``) against
    the peaks those phases measured on the card; each ratio must lie in
    ``DRYRUN_VS_CARD_BOUND``. Beside them, the fake train step's counted
    FLOPs against the analytic ones."""
    rows, failed = {}, []
    for name, card in (("train", train_run["peak_device_bytes"]),
                       ("engine", engine_record["peak_device_bytes"])):
        mem = fake[name]["memory"]
        dry = (mem["argument_gb"] + mem["temp_gb"]) * 1e9
        ratio = card / dry
        rows[name] = {"card_peak_bytes": card, "dryrun_peak_bytes": dry,
                      "argument_gb": mem["argument_gb"], "temp_gb": mem["temp_gb"],
                      "host_gb": mem["host_gb"], "card_over_dryrun": ratio,
                      "counted_flops": fake[name]["counted_flops"],
                      "kernel_flops": fake[name]["kernel_flops"]}
        if not DRYRUN_VS_CARD_BOUND[0] <= ratio <= DRYRUN_VS_CARD_BOUND[1]:
            failed.append(f"{name}: {ratio:.4f}")
    rows["train"]["analytic_flops"] = fake["train"]["analytic_flops"]
    rows["train"]["counted_over_analytic"] = (fake["train"]["counted_flops"]
                                              / fake["train"]["analytic_flops"])
    emit("dryrun_vs_card", bound=DRYRUN_VS_CARD_BOUND, **rows)
    assert not failed, failed


def timed_phase(name: str, fn):
    t0 = time.perf_counter()
    out = fn()
    emit("phase_seconds", of=name, seconds=time.perf_counter() - t0)
    return out


def main() -> int:
    if not (HERE / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: run it from the root of a checkout (no src/repro_torch "
              "beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    if sys.argv[1:2] == ["--dryrun-worker"]:  # a process of phase_dryrun's
        dryrun_worker(*sys.argv[2:4])
        return 0
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    dry_dir = tempfile.mkdtemp()
    try:
        return _main(dry_dir)
    finally:
        shutil.rmtree(dry_dir, ignore_errors=True)


def _main(dry_dir: str) -> int:
    import torch

    from repro_torch.core.hardware import local_cuda_hw

    t0 = time.perf_counter()
    smi = phase_card()
    timed_phase("build", phase_build)
    measured = timed_phase("kernels", phase_kernels)
    hw = local_cuda_hw()  # this card, its host and its host link, read now
    engine_record: dict = {}
    launches = timed_phase("engine", lambda: phase_engine(hw, engine_record))
    gc.collect()  # the engine's weights go with its phase
    torch.cuda.empty_cache()
    training = timed_phase("train_kernels", phase_train_kernels)
    timed_phase("train_compare", phase_train_compare)
    train_launches, train_run = timed_phase("train", phase_train)
    policy_launches, mixed_run = timed_phase("train_policies", phase_train_policies)
    plan_out = timed_phase("plan", lambda: phase_plan(hw))
    phase_calibration(hw, [train_run, mixed_run], plan_out["row"])
    gc.collect()  # the mistral phases' tensors go before the MoE's
    torch.cuda.empty_cache()
    moe_errs = timed_phase("moe_kernels", phase_moe_kernels)
    moe_serve_launches = timed_phase("moe_serve", lambda: phase_moe_serve(hw))
    gc.collect()
    torch.cuda.empty_cache()
    moe_plan_out = timed_phase("moe_plan", lambda: phase_moe_plan(hw))
    gc.collect()
    torch.cuda.empty_cache()
    mamba_errs = timed_phase("mamba_kernels", phase_mamba_kernels)
    mamba_serve_launches = timed_phase("mamba_serve", lambda: phase_mamba_serve(hw))
    gc.collect()
    torch.cuda.empty_cache()
    timed_phase("mamba_train_compare", phase_mamba_train_compare)
    mamba_plan_out = timed_phase("mamba_plan", lambda: phase_mamba_plan(hw))
    emit("mamba_calibration", hw=hw.name, host_bw=hw.host_bw, hbm_bytes=hw.hbm_bytes,
         rows=[mamba_plan_out["row"]])
    gc.collect()
    torch.cuda.empty_cache()
    hybrid_launches = timed_phase("hybrid", lambda: phase_hybrid(hw))
    gc.collect()
    torch.cuda.empty_cache()
    encdec_rows = timed_phase("encdec_kernels", phase_encdec_kernels)
    encdec_serve_launches = timed_phase("encdec_serve", lambda: phase_encdec_serve(hw))
    gc.collect()
    torch.cuda.empty_cache()
    encdec_compare_launches = timed_phase("encdec_train_compare", phase_encdec_train_compare)
    encdec_plan_out = timed_phase("encdec_plan", lambda: phase_encdec_plan(hw))
    emit("encdec_calibration", hw=hw.name, host_bw=hw.host_bw, hbm_bytes=hw.hbm_bytes,
         rows=[encdec_plan_out["row"]])
    gc.collect()
    torch.cuda.empty_cache()
    vlm_rows = timed_phase("vlm_kernels", phase_vlm_kernels)
    vlm_serve_launches, vlm_record = timed_phase("vlm_serve", lambda: phase_vlm_serve(hw))
    vlm_prefill_launches = timed_phase("vlm_prefill", lambda: phase_vlm_prefill(vlm_record))
    del vlm_record  # the served weights
    gc.collect()
    torch.cuda.empty_cache()
    vlm_compare_launches = timed_phase("vlm_train_compare", phase_vlm_train_compare)
    vlm_plan_out = timed_phase("vlm_plan", lambda: phase_vlm_plan(hw))
    emit("vlm_calibration", hw=hw.name, host_bw=hw.host_bw, hbm_bytes=hw.hbm_bytes,
         rows=[vlm_plan_out["row"]])
    gc.collect()
    torch.cuda.empty_cache()
    dist_sync_launches, dist_rows = timed_phase("dist_sync", phase_dist_sync)
    dist_ranks_launches = timed_phase("dist_ranks", phase_dist_ranks)
    dist_xla_launches = timed_phase("dist_xla", lambda: phase_dist_xla(hw))
    tp_launches, tp_rows, tp_pod_launches = timed_phase("tp", phase_tp)
    serve_mesh_launches, serve_mesh_rows = timed_phase("serve_mesh", phase_serve_mesh)
    launcher_launches = timed_phase("launchers", phase_launchers)
    fake = timed_phase("dryrun", lambda: phase_dryrun(dry_dir))
    timed_phase("dryrun_vs_card", lambda: phase_dryrun_vs_card(fake, train_run, engine_record))
    # each path's launches, counted from 0 just before it ran
    by_path = {"engine": launches, "train": train_launches, "train_policies": policy_launches,
               "plan": plan_out["launches"], "moe_serve": moe_serve_launches,
               "moe_plan": moe_plan_out["launches"], "mamba_serve": mamba_serve_launches,
               "mamba_plan": mamba_plan_out["launches"], "hybrid": hybrid_launches,
               "encdec_serve": encdec_serve_launches,
               "encdec_train_compare": encdec_compare_launches,
               "encdec_plan": encdec_plan_out["launches"],
               "vlm_serve": vlm_serve_launches, "vlm_prefill": vlm_prefill_launches,
               "vlm_train_compare": vlm_compare_launches, "vlm_plan": vlm_plan_out["launches"],
               "dist_sync": dist_sync_launches, "dist_ranks": dist_ranks_launches,
               "dist_xla": dist_xla_launches, "tp": tp_launches, "tp_pod": tp_pod_launches,
               "serve_mesh": serve_mesh_launches,
               **{f"launch_{k}": v for k, v in launcher_launches.items()}}
    rms = measured["rmsnorm"][0]  # rows = batch: the decode path's shape
    main_case = next(p for p in measured["paged_attention"]
                     if p["case"] == "main" and p["cold"] == "pinned_host")
    paged_err = max(p["max_abs_err"] for p in measured["paged_attention"])
    rms_err = max(r["max_abs_err"] for r in measured["rmsnorm"])
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")  # device times
    summary = {"kernels": [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:91",
         "launches": launches["paged_attention"], "max_abs_err": paged_err,
         **{k: main_case[k] for k in keys}},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:22",
         "launches": launches["rmsnorm"], "max_abs_err": rms_err,
         **{k: rms[k] for k in keys}},
    ]}
    for name, source, replaces in (
            ("flash_attention", "flash_attention.cu", "src/repro/kernels/flash_attention.py:93"),
            ("flash_attention_bwd", "flash_attention.cu", "src/repro/models/layers.py:221"),
            ("fused_adam", "fused_adam.cu", "src/repro/kernels/fused_adam.py:48"),
            ("fused_quantize_ef", "fused_quant.cu", "src/repro/kernels/fused_quant.py:52")):
        row = training[name]
        # each kernel's launches on the path it came with: the quantizer's
        # on the mixed plan of train_policies, the others' on train
        n = (policy_launches if name == "fused_quantize_ef" else train_launches)[name]
        summary["kernels"].append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": n,
            "max_abs_err": row["max_abs_err"], **{k: row[k] for k in keys}})
    case_keys = ("s", "sk", "hd", "causal", "heads", "family", "case", "cold", "rows", "d",
                 "states", "shape", "model_extent", "max_abs_err") + keys
    for row in summary["kernels"]:
        name = row["name"]
        row["launches_by_path"] = {p: got.get(name, 0) for p, got in by_path.items()}
        # the MoE, Mamba-2, encoder-decoder and VLM shapes' cases held to the same bounds
        row["max_abs_err"] = max([row["max_abs_err"], moe_errs.get(name, 0.0),
                                  mamba_errs.get(name, 0.0)]
                                 + [r["max_abs_err"] for r in
                                    encdec_rows + vlm_rows + dist_rows + tp_rows
                                    + serve_mesh_rows if r["kernel"] == name])
        for key, rows in (("encdec_cases", encdec_rows), ("vlm_cases", vlm_rows),
                          ("dist_cases", dist_rows), ("tp_cases", tp_rows),
                          ("serve_mesh_cases", serve_mesh_rows)):
            # seamless-m4t-large-v2's heads (hd 64, group 1); llava-next-34b's
            # shapes (group 7, d 7168), with mistral-7b's paged group 4 beside
            cases = [{k: r[k] for k in case_keys if k in r} for r in rows if r["kernel"] == name]
            if cases:
                row[key] = cases
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
