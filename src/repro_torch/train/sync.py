"""Gradient-sync strategies: who owns the reduction, and how it runs.

Port of ``src/repro/train/sync.py``. A strategy object owns one
``(sync_mode, layout kind)`` pipeline:

  * ``XlaSync``: ``sync_mode="xla"`` (and the one-rank fallback of a
    manually eligible plan, ``make_strategy``): GSPMD's reduction, then
    ``finalize_grads`` applies the wire numerics (int8 + EF or bf16) to the
    reduced, accumulated gradients. On one rank the reduction is the local
    math. On several (``sharded``) it is the layout of the reference's
    table (``dist/sharding.py``) on the ``(data, model)`` mesh: every plan
    the xla path lowers -- ZeRO-sharded ``hbm`` chunks, host chunks with or
    without ``host_params``, swap blocks, ``zero1_persistent``,
    microbatches -- with ``tp`` / ``exp`` dims split over the model axis
    (``dist/tensor_parallel.py``), or folded into the batch under
    ``dp_only``. A leaf sharded over data is gathered over the data group
    at its point of use (``LazyGather``, ``compress="none"``), so its
    gradient leaves the backward reduce-scattered over the data group; a
    leaf replicated over data has its gradient averaged over the batch
    ranks once the microbatches are accumulated. Over the model axis every
    rank's gradient is already whole (its slice's for a split leaf), so the
    gradients are reduced over the data group only -- under ``dp_only``,
    where the model ranks took other rows, over the model group too. The
    int8 scale is the whole leaf's (``collectives.xla_int8_ef``: a MAX
    all-reduce over every axis the leaf is split on).
  * ``ManualSync``: ``sync_mode="manual"`` over the data-parallel ranks of a
    ``launch.mesh.LocalMesh``; ``dist/collectives.py`` owns the wire. Per
    leaf (``leaf_sync_tree``): a *replicated* leaf (every leaf of a "ddp"
    plan; persistent chunks, norms and dims the world does not divide of a
    ZeRO plan) syncs DDP-style with the int8 all-gather, its residual per
    rank, stored ``(1, *shape)``: this rank's row of the reference's
    stacked ``(n_sync, *shape)`` residual. A *ZeRO-sharded* leaf
    reduce-scatters to shard owners, its residual shard-sized; its fp32
    master, m and v are this rank's shard, updated by the fused Adam kernel.
    "zero2" all-gathers the sharded bf16 leaves once a step, up front, and
    reduce-scatters their gradients after the backward; "zero3" gathers each
    chunk at its point of use through ``collectives.LazyGather``, whose
    backward is the reduce-scatter, so sharded gradients come out of the
    backward shard-sized. In every kind each microbatch's sync collapses the
    gradients to shard size before they are accumulated.

``accumulate_grads`` is the microbatch loop of both; with ``overlap`` it
folds microbatch m-1's synced gradients after microbatch m's backward, so
m-1's collectives (started ``async_op=True``) run under it.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.dist import collectives as COLL
from repro_torch.dist import sharding as SH
from repro_torch.optim.adam import global_norm, sum_sq, tree_leaves, tree_map


class Deferred:
    """A microbatch's gradient tree whose sync may still run: ``wait()``
    returns it."""

    def __init__(self, like, parts: list):
        self.like, self.parts = like, parts

    def wait(self):
        done = iter([p.wait() if isinstance(p, COLL.Pending) else p for p in self.parts])
        return tree_map(lambda _: next(done), self.like)


def ready(g):
    """``g``, or the synced tree a ``Deferred`` ``g`` waits for."""
    return g.wait() if isinstance(g, Deferred) else g


def accumulate_grads(micro_grad, batch: dict, microbatch: int, overlap: bool = False):
    """``micro_grad(mb_batch) -> (grads, loss)`` on one microbatch; ``grads``
    may be a ``Deferred``; ``loss`` is a tensor (the step's ``[loss, ce]``).

    With ``microbatch == 1`` the grads come back as they are (the params'
    dtype). Otherwise each microbatch's grads are added into fp32
    accumulators, which are divided by ``microbatch`` at the end, and the
    losses are averaged. ``overlap`` defers each fold by one microbatch
    (``sync.py:68-131``): the adds are the same, in the same order, so the
    result is bitwise the serial one. Returns ``(grads, loss)``."""
    if microbatch == 1:
        g, loss = micro_grad(batch)
        return ready(g), loss

    def split(x):
        return x.reshape(microbatch, x.shape[0] // microbatch, *x.shape[1:]).unbind(0)

    micro = {k: split(v) for k, v in batch.items()}
    acc = {"grads": None}
    loss = None

    def fold(g):
        g = ready(g)
        if acc["grads"] is None:  # fp32 grads are fresh tensors of ours: accumulate in them
            acc["grads"] = tree_map(lambda t: t.float(), g)
        else:
            tree_map(lambda a, b: a.add_(b), acc["grads"], g)

    pending = None
    for i in range(microbatch):
        g, mb_loss = micro_grad({k: v[i] for k, v in micro.items()})
        loss = mb_loss if loss is None else loss + mb_loss
        if overlap:
            g, pending = pending, g
            if g is None:
                continue
        fold(g)
        del g
    if pending is not None:
        fold(pending)
    grads = tree_map(lambda t: t.div_(microbatch), acc["grads"])
    return grads, loss / microbatch


# ---------------------------------------------------------------------------
# Per-leaf sync descriptors (sync.py:138-193)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LeafSync:
    """How one gradient leaf syncs: ``dim`` is its ZeRO-sharded dim over the
    data axis (reduce-scatter to shard owners) or None (replicated over
    data: the DDP-style gather sync, or the xla path's mean); ``mdim`` the
    dim it splits over the model axis, or None."""

    dim: int | None
    mdim: int | None = None


def leaf_sync_tree(defs, placements: list[str], world: int, model: int = 1,
                   dp_only: bool = False) -> list[LeafSync]:
    """LeafSync descriptors of a ParamDef tree's leaves (``tree_leaves``
    order), each under its chunk's placement, on a ``(world, model)``
    mesh."""
    return [LeafSync(*SH.leaf_dims(d, pl, world, model, dp_only))
            for d, pl in zip(SH.def_leaves(defs), placements)]


def manual_tree_sync(grads: list, errs: list, group, compress: str,
                     leaf_syncs: list[LeafSync], *, async_op: bool = False) -> list:
    """Leaf-wise manual sync of one microbatch's local gradients (flat
    lists): the int8 all-gather (replicated leaves) or the reduce-scatter
    (sharded ones). Residuals are overwritten in place with the new ones.
    With ``async_op`` a replicated leaf's mean may be a ``Pending``."""
    out = []
    for g, e, ls in zip(grads, errs, leaf_syncs):
        if ls.dim is not None:
            s, new = COLL.sync_reduce_scatter(g, e, group, ls.dim, compress, async_op=async_op)
        elif compress == "int8_ef":
            s, new = COLL.manual_int8_ef_sync(g, e, group, async_op=async_op)
        else:
            s, new = (COLL.manual_bf16_mean if compress == "bf16"
                      else COLL.manual_mean)(g, group), e
        if compress == "int8_ef":
            e.copy_(new)
        out.append(s)
    return out


def _local_sq(tensors: list) -> torch.Tensor:
    """The fp32 sum of squares of ``tensors`` (0 for none)."""
    return sum((torch.sum(torch.square(t.float())) for t in tensors), torch.zeros(()))


def grad_norm(grads, leafs: list[LeafSync], mesh) -> torch.Tensor:
    """The global norm of a tree of this rank's parts over ``mesh``'s
    ranks, each leaf counted once across the mesh: its sum of squares,
    kept on a rank where, along each axis, the leaf is split or the rank is
    that axis's rank 0 (a leaf replicated over an axis is equal on its
    ranks), summed over every rank in one all-reduce, then added in
    ``tree_leaves`` order as ``optim.adam.global_norm`` adds them: at world
    one, bitwise its norm."""
    sq = torch.stack([sum_sq(g) for g in tree_leaves(grads)])
    if dist.is_initialized():
        if mesh.rank:
            keep = [float((ls.dim is not None or mesh.data_rank == 0)
                          and (ls.mdim is not None or mesh.model_rank == 0)) for ls in leafs]
            sq = sq * torch.tensor(keep, dtype=sq.dtype, device=sq.device)
        dist.all_reduce(sq, group=mesh.group)
    return torch.sqrt(sum(sq.unbind()))


# ---------------------------------------------------------------------------
# Strategies (sync.py:206-477)
# ---------------------------------------------------------------------------
class XlaSync:
    """GSPMD's reduction, then the wire numerics on the reduced gradients.
    ``sharded`` (default: a world above one) runs the reference's sharded
    layouts over ``mesh``'s ranks; built with ``sharded=True`` at world one
    (over a one-rank process group, or none) every collective is a copy,
    and the step is bitwise the single-device one."""

    manual_active = False
    kind = "xla"

    def __init__(self, plan, mesh, sharded: bool | None = None):
        self.plan, self.mesh = plan, mesh
        self.compress = plan.grad_compress
        self.sharded = mesh.world > 1 if sharded is None else sharded
        self.group = mesh.data_group
        # dp_only: the model ranks took other rows of the batch
        self.fold = plan.dp_only and mesh.model > 1

    def batch_mean(self, x: torch.Tensor, over_data: bool = True) -> torch.Tensor:
        """The mean over the ranks that took other rows of the batch:
        the data group (``over_data``), then under ``dp_only`` the model
        group."""
        if over_data and self.mesh.data > 1:
            x = COLL.manual_mean(x, self.group)
        if self.fold:
            x = COLL.manual_mean(x, self.mesh.model_group)
        return x

    def _wire_groups(self, ls: LeafSync):
        """The groups of the axes a leaf is split on: its int8 scale's MAX
        all-reduce runs over them (None: whole on this rank)."""
        groups = tuple(g for g, split in ((self.group, ls.dim is not None),
                                          (self.mesh.model_group, ls.mdim is not None))
                       if split)
        return groups or None

    def ef_state(self, params, device):
        """The residuals (fp32, on the gradients' ``device``), shaped like
        this rank's params: a sharded leaf's residual is its shard's, as
        the reference shards it like the gradients. None without int8_ef."""
        if self.compress != "int8_ef":
            return None
        return COLL.init_error_feedback(params, device)

    def finalize_grads(self, grads, ef, leafs: list[LeafSync]):
        """The reduction's last part (sharded: the replicated leaves' mean
        over the ranks), then the wire numerics a leaf at a time, the
        residuals updated in place. Returns (grads, metrics)."""
        flat = tree_leaves(grads)
        if self.sharded:
            flat = [self.batch_mean(g, over_data=ls.dim is None) for g, ls in zip(flat, leafs)]
        metrics = {}
        if self.compress == "int8_ef":
            out = []
            for g, e, ls in zip(flat, tree_leaves(ef), leafs):
                s, new = COLL.xla_int8_ef(g, e, self._wire_groups(ls) if self.sharded else None)
                e.copy_(new)
                out.append(s)
            flat = out
            metrics["ef_norm"] = (grad_norm(ef, leafs, self.mesh) if self.sharded
                                  else global_norm(ef))
        elif self.compress == "bf16":
            flat = [COLL.bf16_all_reduce(g) for g in flat]
        return tree_map_flat(grads, flat), metrics

    def update_views(self, params, grads, zero1_dims: list):
        """What ``adam_update`` takes under ``zero1_persistent``: flat lists
        of weights and gradients in which a leaf with a ``zero1_dims`` entry
        (a persistent leaf whose states are shards) is this rank's slice,
        and a ``regather()`` that all-gathers the updated bf16 slices into
        the replicated weights. At world one a slice is the leaf itself."""
        rank, world = self.mesh.data_rank, self.mesh.data
        flat_p, flat_g = tree_leaves(params), tree_leaves(grads)
        if world == 1:
            return flat_p, flat_g, lambda: None
        views = [p if d is None else SH.shard(p.detach(), d, rank, world)
                 for p, d in zip(flat_p, zero1_dims)]
        g_views = [g if d is None else SH.shard(g, d, rank, world)
                   for g, d in zip(flat_g, zero1_dims)]

        @torch.no_grad()
        def regather():
            for p, v, d in zip(flat_p, views, zero1_dims):
                if d is not None:
                    p.copy_(COLL.tiled_all_gather(v, self.group, d))

        return views, g_views, regather


class ManualSync:
    """The step over the data-parallel ranks; ``dist/collectives`` own the
    wire. ``kind`` is ``MemoryPlan.manual_sync_kind``'s ("ddp" | "zero2" |
    "zero3"); a "ddp" plan has no sharded leaves, so its gather is the
    identity and every leaf takes the all-gather sync."""

    manual_active = True

    def __init__(self, plan, mesh, kind: str):
        self.plan, self.mesh, self.kind = plan, mesh, kind
        self.compress = plan.grad_compress
        self.n_sync = mesh.world
        self.group = mesh.group

    # -- state layout ---------------------------------------------------------
    def ef_state(self, params, leafs: list[LeafSync]):
        """The residuals of this rank's (sharded) params: shard-sized for a
        sharded leaf, ``(1, *shape)`` for a replicated one; None without
        int8_ef."""
        if self.compress != "int8_ef":
            return None
        it = iter(leafs)

        def one(p):
            shape = p.shape if next(it).dim is not None else (1,) + tuple(p.shape)
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return tree_map(one, params)

    def local_ef(self, ef, leafs: list[LeafSync]) -> list:
        """This rank's residual of each leaf (flat): the shard, or the
        replicated leaf's row."""
        if ef is None:
            return [None] * len(leafs)
        return [e if ls.dim is not None else e[0] for e, ls in zip(tree_leaves(ef), leafs)]

    def gather_full(self, params, leafs: list[LeafSync]) -> list:
        """The up-front all-gather of every sharded leaf ("zero2"; the
        identity for "ddp"): the full leaves autograd differentiates."""
        return [p if ls.dim is None else
                COLL.tiled_all_gather(p.detach(), self.group, ls.dim).requires_grad_()
                for p, ls in zip(tree_leaves(params), leafs)]

    # -- the step --------------------------------------------------------------
    def ef_norm(self, ef, leafs: list[LeafSync]) -> torch.Tensor:
        """The global residual norm: per-rank values differ, so the squared
        sums are reduced."""
        sq = _local_sq(self.local_ef(ef, leafs))
        sq = sq.to(tree_leaves(ef)[0].device)
        if dist.is_initialized():
            dist.all_reduce(sq, group=self.group)
        return torch.sqrt(sq)

    def micro_grad(self, params, ef, leafs: list[LeafSync], *, loss, lazy_loss=None):
        """``micro_grad(mb_batch) -> (grads, [loss, ce])`` for
        ``accumulate_grads``: one microbatch's gradients, synced (shard-sized
        for sharded leaves) and, under overlap, ``Deferred``. ``loss(full
        params tree, batch)`` takes full leaves ("ddp" / "zero2");
        ``lazy_loss(params, batch)`` gathers each chunk at its point of use
        ("zero3"), and its backward reduce-scatters the sharded leaves."""
        errs = self.local_ef(ef, leafs)
        overlap = self.plan.overlap
        if self.kind == "zero3":
            wrt = tree_leaves(params)
            # sharded leaves were reduce-scattered in the backward
            todo = [i for i, ls in enumerate(leafs) if ls.dim is None]
            run_loss = lambda mb: lazy_loss(params, mb)  # noqa: E731
        else:
            wrt = self.gather_full(params, leafs)
            todo = list(range(len(leafs)))
            full_tree = tree_map_flat(params, wrt)
            run_loss = lambda mb: loss(full_tree, mb)  # noqa: E731

        def micro(mb):
            total, ce = run_loss(mb)
            synced = list(torch.autograd.grad(total, wrt))
            out = manual_tree_sync([synced[i] for i in todo], [errs[i] for i in todo],
                                   self.group, self.compress, [leafs[i] for i in todo],
                                   async_op=overlap)
            for i, s in zip(todo, out):
                synced[i] = s
            losses = torch.stack([total, ce]).detach()
            if overlap:
                return Deferred(params, synced), losses
            return tree_map_flat(params, synced), losses

        return micro


def tree_map_flat(like, flat: list):
    """A tree shaped like ``like`` with the leaves of ``flat`` in order."""
    it = iter(flat)
    return tree_map(lambda _: next(it), like)


def make_strategy(plan, mesh, tp_degree: int | None = None) -> XlaSync | ManualSync:
    """The sync strategy of a plan on a mesh. Raises the reference's
    ``ValueError`` for a manual plan no kind lowers, at every world size:
    with a model axis (``tp_degree``, default the mesh's model extent)
    only an all-persistent plan under ``dp_only`` lowers, as "ddp"
    (``core/plan.manual_sync_kind``). A manual plan on one rank falls back
    to ``XlaSync`` (the local math is the collective); the xla path runs
    ``XlaSync``, sharded on several ranks, with or without a model axis."""
    tp_degree = mesh.model if tp_degree is None else tp_degree
    if plan.sync_mode == "manual":
        kind = plan.manual_sync_kind(tp_degree)
        if kind is None:
            raise ValueError(
                "sync_mode='manual' requires a layout the manual step can "
                "lower: no swap blocks, no host-resident chunks, no "
                "zero1_persistent, and tp_degree == 1. Got "
                f"{plan.describe()} on tp_degree={tp_degree}. "
                "See MemoryPlan.manual_sync_kind.")
        if mesh.world == 1:
            return XlaSync(plan, mesh)
        return ManualSync(plan, mesh, kind)
    return XlaSync(plan, mesh)


# ---------------------------------------------------------------------------
# Telemetry: static per-step wire-byte inventory (sync.py:480-530)
# ---------------------------------------------------------------------------
def record_sync_inventory(strategy, defs, leafs: list[LeafSync], microbatch: int,
                          registry) -> dict[str, int]:
    """Record the step's logical collective payload as gauges, from the
    parameter defs: ``sync.wire_bytes_per_step{strategy, op=grad_sync}``
    (every leaf at the payload width: 1 B int8_ef, 2 B bf16, 4 B fp32),
    ``{op=param_gather}`` (bf16 gathers of sharded leaves: once a step for
    zero2, once a microbatch for zero3, before re-gathers) and
    ``sync.wire_payload{strategy}``. Logical payload bytes, not per-link
    ring traffic."""
    kind = getattr(strategy, "kind", "xla")
    itemsize = {"int8_ef": 1, "bf16": 2}.get(strategy.compress, 4)
    grad_bytes = gather_bytes = 0
    for d, ls in zip(SH.def_leaves(defs), leafs):
        n = math.prod(d.shape)
        grad_bytes += n * itemsize
        if kind in ("zero2", "zero3") and ls.dim is not None:
            gather_bytes += n * 2
    if kind == "zero3":
        gather_bytes *= microbatch
    registry.gauge("sync.wire_bytes_per_step", strategy=kind, op="grad_sync").set(grad_bytes)
    registry.gauge("sync.wire_bytes_per_step", strategy=kind, op="param_gather").set(
        gather_bytes)
    registry.gauge("sync.wire_payload", strategy=kind).set(itemsize)
    return {"grad_sync": grad_bytes, "param_gather": gather_bytes,
            "payload_itemsize": itemsize}
