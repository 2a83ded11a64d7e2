"""How a parameter leaf, a batch and an activation are sharded over the
``(pod, data, model)`` mesh.

Port of ``src/repro/dist/sharding.py``. Every ``ParamDef`` names its dims
with tags (``models/layers.py``); under a ``MemoryPlan`` the reference's
table (``:7-13``) places them:

  tag       persist            hbm / host               dp_only
  ------    ----------------   ----------------------   -----------------
  zero      replicated         sharded over data        sharded over data
  tp/exp    "model" axis       "model" axis             replicated

(``_spec``, ``:78-96``). A dim shards only when the extent divides it
(``_fits``, ``:70-75``), so one model under one plan has both kinds of
leaves -- seamless-m4t-large-v2's 256,206-row vocab stays whole at a
model extent of 4 -- and ``_fits`` looks at the flattened dim, not at
whole heads: at 2 KV heads over a model extent of 4, ``wk``'s columns
shard as half-heads (``models/layers.qkv`` gathers them at use), and
Mamba-2's ``in_proj`` (``[z | x | B | C | dt]``) and conv (``[x | B |
C]``) shard as flat slices that cut across the segments
(``models/mamba2.rank_params`` gathers them at use). A rank's shard is
the reference's in every case, so Adam, the norms, the int8 scale and the
data axis's gather see the reference's leaves. Each rank holds
its shard, 2-D where both dims shard (``wq``: ``(zero, tp)``): slice
``data_rank`` of ``data`` along the data dim, then ``model_rank`` of
``model`` along the model dim (``shard2``), the layout ``jax.device_put``
gives a ``NamedSharding`` over both axes. ``leaf_dims`` is the pair (None:
replicated over that axis); ``leaf_sync_dim`` the data dim, the one the
manual sync reduce-scatters and the xla path's ``LazyGather`` gathers over
the data group -- a gathered leaf stays split over ``model``, as
``gather_sharding`` (``:110-113``) keeps the TP dims. At a data extent of
one beside a model axis the data dims are None: there is nothing to gather.

The placements of the xla path on several ranks: a ``host`` chunk's shard
lies in pinned host memory under ``host_params`` and on the device under
the ZeRO-Offload split (the reference's ``param_place``,
``step_builder.py:146-148``); its optimizer states are pinned shards. A
persistent leaf's optimizer states shard over data as an ``hbm`` leaf's
under ``zero1_persistent`` while its weights stay replicated over data
(``opt_dim``). The batch splits over ``batch_axes``: the zero axes (``pod``
and ``data``, pod-major), and under ``dp_only`` the model axis too
(``:53-55``), a rank taking its slice of each microbatch
(``xla_batch_split``). ``shard_activation`` is
the activation sharder's three kinds (``make_activation_sharder``,
``:214-243``) as this rank's part of a whole tensor: ``bsd`` a
block boundary (batch over the batch axes, the sequence over ``model``
under ``seq_shard_acts``), ``enter`` batch only, ``logits`` the vocab
dim over ``model``. Memory kinds and ``NamedSharding`` have no counterpart
here. On the multi-pod mesh the reference's zero axes are ``("pod",
"data")`` (``:13-15, 46-53``); the port's "data" extent and rank are
theirs (``launch/mesh.LocalMesh.data``: ``pod * data``, pod-major), so
every table above reads the same across pods.

Serving (``build_serve_params`` and ``_serve_cache_layout`` of the
reference's step builder): ``serve_placements`` places the serve tree's
parts by the plan's chunks (the embedding and encoder at chunk 0, the
layer stack at chunk 1, the final norm and head at the last), ``serve_dims``
gives each leaf's data and model dims by the table above, ``serve_shards``
a rank's shards, and ``slot_split`` a rank's cache slots: ``B / data``
where the data extent divides B, else every slot on every data rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.layers import TP, ZERO, ParamDef, map_defs
from repro_torch.models.moe import EXP
from repro_torch.optim.adam import tree_map


def _fits(world: int, dim: int) -> bool:
    return world == 1 or (dim % world == 0 and dim >= world)


def _spec(d: ParamDef, world: int, placement: str) -> int | None:
    """The dim of ``d`` sharded over a data extent of ``world`` under
    ``placement``, or None: the first ``zero`` dim that ``world`` divides,
    for a non-persistent chunk."""
    if placement == "persist":
        return None
    for i, (n, tag) in enumerate(zip(d.shape, d.axes)):
        if tag == ZERO and _fits(world, n):
            return i
    return None


def model_dim(d: ParamDef, model: int, dp_only: bool = False) -> int | None:
    """The dim of ``d`` sharded over a model extent of ``model``, or None:
    the first ``tp`` or ``exp`` dim that ``model`` divides, unless
    ``dp_only`` keeps them replicated or there is no model axis."""
    if model == 1 or dp_only:
        return None
    for i, (n, tag) in enumerate(zip(d.shape, d.axes)):
        if tag in (TP, EXP) and _fits(model, n):
            return i
    return None


def leaf_dims(d: ParamDef, placement: str, data: int, model: int = 1,
              dp_only: bool = False) -> tuple[int | None, int | None]:
    """(data dim, model dim) of ``d`` on a ``(data, model)`` mesh."""
    ddim = None if model > 1 and data == 1 else _spec(d, data, placement)
    return ddim, model_dim(d, model, dp_only)


def leaf_sync_dim(d: ParamDef, world: int, placement: str) -> int | None:
    """The dim the manual sync reduce-scatters a leaf's gradient over (the
    dim its shards split over ``world`` data ranks), or None for a
    replicated leaf."""
    return _spec(d, world, placement)


def opt_dim(d: ParamDef, world: int, placement: str, zero1: bool) -> int | None:
    """The data dim a leaf's fp32 master, m and v shard over
    (``_opt_placement``, ``step_builder.py:112-123``): its weights' dim,
    except that a persistent leaf's states shard as an ``hbm`` leaf's under
    ``zero1_persistent``."""
    return _spec(d, world, "hbm" if placement == "persist" and zero1 else placement)


def def_leaves(tree) -> list[ParamDef]:
    """ParamDefs of a nested dict (or list) in ``tree_leaves`` order."""
    if isinstance(tree, ParamDef):
        return [tree]
    if isinstance(tree, dict):
        return [d for k in sorted(tree) for d in def_leaves(tree[k])]
    return [d for v in tree for d in def_leaves(v)]


# ---------------------------------------------------------------------------
# Batch and activations (sharding.py:53-55, 206-243)
# ---------------------------------------------------------------------------
def batch_axes(mesh, dp_only: bool = False) -> tuple[str, ...]:
    """The axes the batch dim shards over: the zero axes (``pod`` and
    ``data``); under ``dp_only`` the model axis joins them."""
    zero = ("pod", "data") if getattr(mesh, "pod", 1) > 1 else ("data",)
    return zero + ("model",) if dp_only and mesh.model > 1 else zero


def batch_extent(mesh, dp_only: bool = False) -> tuple[int, int]:
    """(this rank's index, the extent) along the batch axes, pod-major:
    the row-major rank over them, as the reference's batch spec
    ``P(("pod", "data"))`` orders its shards."""
    if dp_only and mesh.model > 1:
        return mesh.rank, mesh.world
    return mesh.data_rank, mesh.data


def manual_batch_split(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """This rank's rows of a global batch input: its leading dim split in
    ``world`` equal slices (the ``P("data", None, ...)`` in_spec of
    ``manual_batch_pspec``, ``:165``)."""
    if x.shape[0] % world:
        raise ValueError(f"batch of {x.shape[0]} rows does not split over {world} ranks")
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


def xla_batch_split(x: torch.Tensor, rank: int, world: int,
                    microbatch: int = 1) -> torch.Tensor:
    """This rank's rows of a global batch input on the xla path: its slice
    of each microbatch, in microbatch order. The reference's microbatch m
    is the global rows ``[m B / M, (m + 1) B / M)`` split over the batch
    axes (``accumulate_grads``, ``train/sync.py:93-95``), so the m-th
    contiguous slice of a rank's rows (``train/sync.accumulate_grads``)
    is its part of microbatch m; at one microbatch these are its
    contiguous rows (``manual_batch_split``)."""
    if x.shape[0] % (world * microbatch):
        raise ValueError(f"batch of {x.shape[0]} rows does not split over {world} ranks "
                         f"and {microbatch} microbatches")
    parts = x.reshape(microbatch, world, x.shape[0] // (world * microbatch), *x.shape[1:])
    return parts[:, rank].reshape(-1, *x.shape[1:])


def shard_activation(x: torch.Tensor, kind: str, mesh, plan=None) -> torch.Tensor:
    """This rank's part of a whole activation ``x`` under the reference's
    sharder: the batch dim over the batch axes (where they divide it);
    ``logits``: the last dim over ``model``; ``bsd`` under
    ``seq_shard_acts``: the sequence dim over ``model``; ``enter``: batch
    only."""
    if kind not in ("bsd", "enter", "logits"):
        raise ValueError(f"activation kind {kind!r}")
    dp = bool(getattr(plan, "dp_only", False))
    idx, ext = batch_extent(mesh, dp)
    if x.ndim < 2:
        return x
    if _fits(ext, x.shape[0]):
        x = shard(x, 0, idx, ext)
    tp = mesh.model > 1 and not dp
    if kind == "logits" and tp and _fits(mesh.model, x.shape[-1]):
        return shard(x, x.ndim - 1, mesh.model_rank, mesh.model)
    if (kind == "bsd" and tp and getattr(plan, "seq_shard_acts", False)
            and _fits(mesh.model, x.shape[1])):
        return shard(x, 1, mesh.model_rank, mesh.model)
    return x


# ---------------------------------------------------------------------------
# Shards of a leaf
# ---------------------------------------------------------------------------
def shard(t: torch.Tensor, dim: int | None, rank: int, world: int) -> torch.Tensor:
    """This rank's contiguous shard of the full leaf ``t`` along ``dim``
    (``t`` itself for a replicated leaf)."""
    if dim is None or world == 1:
        return t
    return t.chunk(world, dim)[rank].clone(memory_format=torch.contiguous_format)


def shard2(t: torch.Tensor, ddim: int | None, mdim: int | None, mesh) -> torch.Tensor:
    """This rank's 2-D shard of the full leaf ``t``: its data slice along
    ``ddim``, then its model slice along ``mdim``."""
    t = shard(t, ddim, mesh.data_rank, mesh.data)
    return shard(t, mdim, mesh.model_rank, mesh.model)


def unshard(t: torch.Tensor, dim: int | None, world: int, group=None) -> torch.Tensor:
    """The full leaf from every rank's shard ``t`` (an all-gather along
    ``dim``; ``t`` itself for a replicated leaf or a world of one)."""
    if dim is None or world == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def unshard2(t: torch.Tensor, ddim: int | None, mdim: int | None, mesh) -> torch.Tensor:
    """The full leaf from every rank's 2-D shard: gathered over the model
    group, then over the data group."""
    t = unshard(t, mdim, mesh.model, mesh.model_group)
    return unshard(t, ddim, mesh.data, mesh.data_group)


# ---------------------------------------------------------------------------
# Serving (build_serve_params, step_builder.py:589-642; _serve_cache_layout,
# :645-731)
# ---------------------------------------------------------------------------
def serve_placements(plan) -> dict[str, str]:
    """Each part of the serve tree's placement, as ``build_serve_params``
    places them: the embedding and the encoder at chunk 0's, the layer stack
    at chunk 1's, the final norm and the head at the last chunk's. Serving
    keeps weights only, so a ``host`` chunk would hold its weights in host
    memory, which the port's serving step does not read (ROADMAP.md)."""
    first, last = plan.chunk_placement(0), plan.chunk_placement(plan.n_chunks - 1)
    out = {"embed": first, "encoder": first, "blocks": plan.chunk_placement(1),
           "final_norm": last, "head": last}
    if "host" in out.values():
        raise NotImplementedError(f"serving plan {plan.describe()}: weight chunks in host "
                                  "memory (ROADMAP.md)")
    return out


def serve_dims(defs: dict, plan, mesh) -> tuple[dict, dict]:
    """(data dims, model dims): two trees of the serve tree's ``defs``
    (ParamDefs) holding each leaf's dim sharded over the data ranks (its
    ``zero`` dim where its part is not persistent and the extent divides
    it, ``_spec``) and over the model ranks (``model_dim``), or None."""
    place = serve_placements(plan)

    def ddim(d: ParamDef, placement: str) -> int | None:
        return None if mesh.data == 1 else _spec(d, mesh.data, placement)

    data = {k: map_defs(lambda d, p=place[k]: ddim(d, p), sub) for k, sub in defs.items()}
    model = {k: map_defs(lambda d: model_dim(d, mesh.model), sub) for k, sub in defs.items()}
    return data, model


def serve_shards(params: dict, defs: dict, plan, mesh) -> dict:
    """This rank's shards of the whole serve tree ``params``: each leaf's
    data slice (``serve_dims``), then its model slice (``shard2``)."""
    data, model = serve_dims(defs, plan, mesh)
    return {k: tree_map(lambda t, dd, md: shard2(t, dd, md, mesh), params[k], data[k],
                        model[k]) for k in params}


def slot_split(batch: int, mesh) -> tuple[int, int]:
    """(this rank's first slot, its slots): ``batch / data`` a rank where the
    data extent divides the batch, as the reference's ``fits(bsz, ba)``
    shards the cache and the tokens; otherwise every data rank holds every
    slot."""
    if mesh is None or not _fits(mesh.data, batch):
        return 0, batch
    n = batch // mesh.data
    return mesh.data_rank * n, n
