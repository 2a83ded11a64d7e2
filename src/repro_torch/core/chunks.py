"""Chunk inventory of a model in execution order (paper §3.1.1, §B.1).

Copy of ``src/repro/core/chunks.py``: the embedding chunk, one chunk per
superblock repeat, then the head -- the planner's unit. ``chunk_size_search``
is the paper's fixed-size chunk search (padding-waste minimization), kept
for parity; the planner itself uses block-aligned chunks.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.layers import ParamDef

BYTES = {"bfloat16": 2, "float32": 4, "float16": 2}


def _defs_leaves(defs) -> list[ParamDef]:
    if isinstance(defs, ParamDef):
        return [defs]
    return [d for k in sorted(defs) for d in _defs_leaves(defs[k])]


def _tree_param_bytes(defs) -> tuple[int, int]:
    """(total param count, total param bytes) of a ParamDef tree."""
    leaves = _defs_leaves(defs)
    count = sum(math.prod(d.shape) for d in leaves)
    nbytes = sum(math.prod(d.shape) * BYTES[d.dtype] for d in leaves)
    return count, nbytes


@dataclasses.dataclass(frozen=True)
class ChunkInfo:
    index: int  # execution order
    name: str
    param_count: int
    param_bytes: int  # compute-dtype bytes
    is_block: bool  # True for superblock chunks (have activations/FLOPs)
    block_index: int = -1  # which activation block this chunk backs

    @property
    def grad_bytes(self) -> int:
        return self.param_bytes  # grads kept in compute dtype

    @property
    def optim_bytes(self) -> int:
        # fp32 master + Adam m + v (mixed-precision training, paper §2)
        return 12 * self.param_count


def chunk_inventory(cfg: ModelConfig) -> list[ChunkInfo]:
    """Execution-order chunks: [embed(+encoder)] [superblock x R] [head]."""
    defs = M.param_defs(cfg)
    r = M.num_repeats(cfg)
    front = {"embed": defs["embed"]}
    if "encoder" in defs:
        front["encoder"] = defs["encoder"]
    cnt, nbytes = _tree_param_bytes(front)
    chunks = [ChunkInfo(0, "embed", cnt, nbytes, is_block=False)]
    # one chunk per superblock repeat; stacked defs are divided evenly by R
    cnt_all, bytes_all = _tree_param_bytes(defs["blocks"])
    per_cnt, per_bytes = cnt_all // r, bytes_all // r
    for i in range(r):
        chunks.append(ChunkInfo(1 + i, f"superblock{i}", per_cnt, per_bytes, is_block=True,
                                block_index=i))
    tail = {"final_norm": defs["final_norm"]}
    if "head" in defs:
        tail["head"] = defs["head"]
    cnt, nbytes = _tree_param_bytes(tail)
    chunks.append(ChunkInfo(1 + r, "head", cnt, nbytes, is_block=False))
    return chunks


def total_param_count(chunks: list[ChunkInfo]) -> int:
    return sum(c.param_count for c in chunks)


def model_state_bytes(chunks: list[ChunkInfo]) -> int:
    """Full mixed-precision model states: ~16 bytes/param (paper §1)."""
    return sum(c.param_bytes + c.grad_bytes + c.optim_bytes for c in chunks)


# ---------------------------------------------------------------------------
# §B.1 fixed-size chunk search (padding-waste minimization)
# ---------------------------------------------------------------------------
def pack_into_chunks(param_sizes: list[int], chunk_size: int) -> list[list[int]]:
    """Greedy packing in execution order; params never span chunk boundaries.

    Params larger than the chunk get a dedicated (oversized) chunk, as in
    Colossal-AI's chunk manager.
    """
    chunks: list[list[int]] = []
    cur: list[int] = []
    cur_sz = 0
    for s in param_sizes:
        if s >= chunk_size:
            if cur:
                chunks.append(cur)
                cur, cur_sz = [], 0
            chunks.append([s])
            continue
        if cur_sz + s > chunk_size:
            chunks.append(cur)
            cur, cur_sz = [], 0
        cur.append(s)
        cur_sz += s
    if cur:
        chunks.append(cur)
    return chunks


def chunk_waste(param_sizes: list[int], chunk_size: int) -> int:
    """Total padding bytes when packing params into fixed-size chunks.

    Oversized (dedicated) chunks are exact-fit: ``max(chunk_size, total)``
    equals ``total`` whenever ``total >= chunk_size``, so they contribute
    zero padding."""
    waste = 0
    for chunk in pack_into_chunks(param_sizes, chunk_size):
        total = sum(chunk)
        waste += max(chunk_size, total) - total
    return waste


def chunk_size_search(
    param_sizes: list[int],
    candidates: list[int] | None = None,
) -> tuple[int, int]:
    """Grid search over chunk sizes minimizing simulated waste (§B.1).

    Returns (best_chunk_size, waste_bytes). Ties prefer larger chunks
    (better transfer efficiency).
    """
    if candidates is None:
        candidates = [1 << p for p in range(20, 29)]  # 1 MiB .. 256 MiB elems
    best, best_waste = candidates[0], None
    for c in candidates:
        w = chunk_waste(param_sizes, c)
        if best_waste is None or w < best_waste or (w == best_waste and c > best):
            best, best_waste = c, w
    return best, int(best_waste)
