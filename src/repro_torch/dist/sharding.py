"""How a parameter leaf is sharded over the data extent.

Port of the data-axis part of ``src/repro/dist/sharding.py``. Every
``ParamDef`` names its dims with tags (``models/layers.py``); under a
``MemoryPlan`` a leaf of a non-persistent chunk shards its ``zero``-tagged
dim over the ZeRO axes, and a persistent chunk's leaves stay replicated
(``_spec``, ``:78-96``). A dim shards only when the extent divides it
(``_fits``, ``:70-75``), so one model under one plan has both kinds of
leaves. Each rank holds its shard: the slice ``rank`` of ``world`` equal
slices along that dim (``shard``), the layout ``jax.device_put`` gives a
``NamedSharding`` over the data axis. ``leaf_sync_dim`` is that dim (None:
replicated), the one the manual sync reduce-scatters over.

The placements of the xla path on several ranks (the table at the top of
the reference): a ``host`` chunk's shard lies in pinned host memory under
``host_params`` and on the device under the ZeRO-Offload split (the
reference's ``param_place``, ``step_builder.py:146-148``); its optimizer
states are pinned shards. A persistent leaf's optimizer states shard as an
``hbm`` leaf's under ``zero1_persistent`` while its weights stay
replicated (``opt_dim``). The gather target is the full leaf on the device
(``unshard``, or ``dist.collectives.LazyGather`` at the point of use). Memory kinds,
``NamedSharding`` and the activation sharder have no counterpart here; the
model axis (TP) and ``dp_only``'s folding of it wait in ROADMAP.md.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.layers import ZERO, ParamDef


def _fits(world: int, dim: int) -> bool:
    return world == 1 or (dim % world == 0 and dim >= world)


def _spec(d: ParamDef, world: int, placement: str) -> int | None:
    """The dim of ``d`` sharded over the data extent under ``placement``,
    or None: the first ``zero`` dim that ``world`` divides, for a
    non-persistent chunk."""
    if placement == "persist":
        return None
    for i, (n, tag) in enumerate(zip(d.shape, d.axes)):
        if tag == ZERO and _fits(world, n):
            return i
    return None


def leaf_sync_dim(d: ParamDef, world: int, placement: str) -> int | None:
    """The dim the manual sync reduce-scatters a leaf's gradient over (the
    dim its shards split), or None for a replicated leaf."""
    return _spec(d, world, placement)


def opt_dim(d: ParamDef, world: int, placement: str, zero1: bool) -> int | None:
    """The dim a leaf's fp32 master, m and v shard over (``_opt_placement``,
    ``step_builder.py:112-123``): its weights' dim, except that a persistent
    leaf's states shard as an ``hbm`` leaf's under ``zero1_persistent``."""
    return _spec(d, world, "hbm" if placement == "persist" and zero1 else placement)


def def_leaves(tree) -> list[ParamDef]:
    """ParamDefs of a nested dict (or list) in ``tree_leaves`` order."""
    if isinstance(tree, ParamDef):
        return [tree]
    if isinstance(tree, dict):
        return [d for k in sorted(tree) for d in def_leaves(tree[k])]
    return [d for v in tree for d in def_leaves(v)]


def manual_batch_split(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """This rank's rows of a global batch input: its leading dim split in
    ``world`` equal slices (the ``P("data", None, ...)`` in_spec of
    ``manual_batch_pspec``, ``:165``)."""
    if x.shape[0] % world:
        raise ValueError(f"batch of {x.shape[0]} rows does not split over {world} ranks")
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


def shard(t: torch.Tensor, dim: int | None, rank: int, world: int) -> torch.Tensor:
    """This rank's contiguous shard of the full leaf ``t`` along ``dim``
    (``t`` itself for a replicated leaf)."""
    if dim is None or world == 1:
        return t
    return t.chunk(world, dim)[rank].clone(memory_format=torch.contiguous_format)


def unshard(t: torch.Tensor, dim: int | None, world: int, group=None) -> torch.Tensor:
    """The full leaf from every rank's shard ``t`` (an all-gather along
    ``dim``; ``t`` itself for a replicated leaf or a world of one)."""
    if dim is None or world == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)
