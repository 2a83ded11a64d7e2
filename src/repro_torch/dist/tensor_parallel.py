"""The model axis's collectives: Megatron-style tensor parallelism.

The reference lets GSPMD partition the one-device program over the
``"model"`` axis: ``tp``- and ``exp``-tagged dims split there
(``dist/sharding.py``) and ``shard_act`` pins the activations
(``src/repro/models/model.py:314, 333, 628, 634``). The port writes the
partitioned program out, as Megatron-LM does, with the collectives of
``TensorParallel`` -- a rank's view of its model group -- as
``torch.autograd.Function``s over that group:

  * ``copy``: identity forward, all-reduce backward: the input of a
    column-parallel layer, whose gradient each rank holds a part of;
  * ``reduce``: all-reduce forward, identity backward: the output of a
    row-parallel layer;
  * under ``seq_shard_acts`` (sequence parallelism) the block boundary is
    split over the sequence: ``gather_partial`` (all-gather forward,
    reduce-scatter backward) takes the place of ``copy`` at a sublayer's
    entry and ``scatter_partial`` (reduce-scatter forward, all-gather
    backward) that of ``reduce`` at its exit;
  * ``gather`` / ``split`` move a whole tensor between ranks whose
    consumers compute the same thing on every rank (the MoE router, a
    sublayer whose weights are replicated, the combine weights of the
    experts a rank does not hold): their backwards slice and all-gather.

A sublayer's value ``y = f(x)`` is *partial* when each rank computes a
part whose sum over the model ranks is ``y`` (its weights split over the
model axis), *replicated* when every rank computes all of it. ``enter`` and
``exit`` are the two kinds' boundaries in both layouts. Every gradient that
leaves a sublayer is whole on every rank, so a leaf replicated over the
model axis takes the same gradient on every model rank, and a split leaf
its slice's: the data sync then reduces over the data group only. Norm
scales under sequence parallelism see a rank's rows only; ``copy`` sums
their gradients over the model group (``norm_params``).

``vocab_embed`` is the vocab-parallel lookup: each rank looks up its vocab
range, zeroes the rows of other tokens, then the partial rows are reduced
(summing one row with zeros: the lookup exactly). A world of one, or no
``TensorParallel`` (None), is the one-device program.

Every family splits so: attention and MLPs (the decoder's, the encoder's
and the cross-attention's), the experts, and the Mamba-2 mixer on a rank's
SSD heads (``models/mamba2.py``). A leaf whose split does not follow whole
heads (Mamba-2's ``in_proj`` and conv, whose ``tp`` dim packs ``[z | x |
B | C | dt]`` flat) is taken whole at use (``whole_weight``) and a rank
reads its heads' columns, as ``wk`` at part-heads; ``own_part`` is a
rank's heads of a leaf that splits by whole heads, or of one left whole.

Where the extent does not divide a sublayer's heads (attention's query
heads, or a rank's query heads straddling their KV heads; Mamba-2's SSD
heads) the sublayer runs replicated: each rank takes its weights whole at
use (``replicated``: all-gathered, the backward keeping this rank's slice
of the equal gradients) and computes every head, entering and leaving as
a replicated sublayer. GSPMD splits those flat dims wherever the extent
divides them, and computes the same function.

``BatchGroup`` is the other side of the xla path's layout: the ranks that
hold other rows of one batch (the data group, and under ``dp_only`` every
rank). The reference routes an MoE over the global batch in one program;
the port's ranks route theirs over the group's tokens through its
collectives (``models/moe.apply_moe``); so do the data ranks of a serving
mesh over the slots they split.

Serving adds plain functions over a group, with no backward:
``vocab_argmax`` (the greedy token from each rank's vocab slice: every
rank's (max, index) all-gathered, the largest kept, the lowest index on
ties), ``gather_vocab`` (the whole logits) and ``gather_rows`` (the data
group's rows: next tokens or logits of the slots each rank serves).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def _all_gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order."""
    dim %= x.dim()
    flat = x.contiguous().reshape(-1)
    out = torch.empty(n * flat.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    parts = out.view((n,) + tuple(x.shape))
    full = list(x.shape)
    full[dim] *= n
    return parts.movedim(0, dim).reshape(full)


def _reduce_scatter(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum over the ranks of ``x``."""
    dim %= x.dim()
    s = x.shape[dim] // n
    parts = x.reshape(x.shape[:dim] + (n, s) + x.shape[dim + 1:]).movedim(dim, 0)
    parts = parts.contiguous()
    out = torch.empty(parts.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out.view(-1), parts.view(-1), group=group)
    return out


def _slice(x: torch.Tensor, rank: int, n: int, dim: int) -> torch.Tensor:
    return x.chunk(n, dim)[rank].contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherPartial(torch.autograd.Function):
    """All-gather along ``dim``; the consumers' gradients are parts of the
    whole: reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _all_gather(x, tp.group, tp.size, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.tp.group, ctx.tp.size, ctx.dim), None, None


class _ScatterPartial(torch.autograd.Function):
    """Reduce-scatter along ``dim`` of the ranks' parts; all-gather
    backward."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _reduce_scatter(x, tp.group, tp.size, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.tp.group, ctx.tp.size, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` for consumers that compute the same on
    every rank: backward keeps this rank's slice of the (equal) gradient."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _all_gather(x, tp.group, tp.size, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.tp.rank, ctx.tp.size, ctx.dim), None, None


class _Split(torch.autograd.Function):
    """This rank's slice along ``dim`` of a tensor every rank holds whole;
    backward all-gathers the slices' gradients."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _slice(x, tp.rank, tp.size, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.tp.group, ctx.tp.size, ctx.dim), None, None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's view of its model group: ``rank`` of ``size``, and
    whether block boundaries are split over the sequence (``seq``)."""

    group: object
    rank: int
    size: int
    seq: bool = False

    # -- the primitives -------------------------------------------------------
    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self)

    def gather_partial(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherPartial.apply(x, self, dim)

    def scatter_partial(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _ScatterPartial.apply(x, self, dim)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(x, self, dim)

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Split.apply(x, self, dim)

    def reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the ranks (no gradient)."""
        return _all_reduce(x, self.group, dist.ReduceOp.MAX)

    def reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum over the ranks (no gradient)."""
        return _all_reduce(x, self.group)

    # -- a sublayer's boundaries ------------------------------------------------
    def enter(self, x: torch.Tensor, partial: bool = True) -> torch.Tensor:
        """A sublayer's input in the whole-sequence layout: its gradient
        summed over the ranks for a ``partial`` sublayer, kept as it is for
        a replicated one. ``x`` (B, S or S / size, D) is the block
        boundary."""
        if self.seq:
            return self.gather_partial(x, 1) if partial else self.gather(x, 1)
        return self.copy(x) if partial else x

    def exit(self, y: torch.Tensor, partial: bool = True) -> torch.Tensor:
        """A sublayer's output ``y`` (B, S, D) back in the block boundary's
        layout: summed over the ranks if ``partial``."""
        if self.seq:
            return self.scatter_partial(y, 1) if partial else self.split(y, 1)
        return self.reduce(y) if partial else y

    def norm_params(self, params: dict) -> dict:
        """A norm's parameters: under sequence parallelism each rank's
        gradient covers its rows, so it is summed over the ranks."""
        if not self.seq:
            return params
        return {k: self.copy(v) for k, v in params.items()}

    def own_part(self, w: torch.Tensor, dim: int, full: int, start: int,
                 length: int) -> torch.Tensor:
        """This rank's part ``[start, start + length)`` along ``dim`` of a
        leaf ``full`` long there: ``w`` itself where the leaf splits over
        the model axis (the caller's part is then this rank's shard), else
        the slice of the whole leaf, its gradient summed over the ranks."""
        if w.shape[dim] != full:
            return w
        return self.copy(w).narrow(dim, start, length)

    def replicated(self, w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
        """The whole weight (``full`` along ``dim``) for a replicated
        consumer, which computes the same on every rank: all-gathered if
        this rank holds a shard (the backward keeps this rank's slice of the
        equal gradients), else ``w`` itself."""
        if w.shape[dim] == full:
            return w
        return self.gather(w, dim)

    def whole_weight(self, w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
        """The whole weight (``full`` along ``dim``) for a partial consumer
        that reads a slice of it: all-gathered if this rank holds a shard
        (reduce-scatter backward), else ``w`` with its gradient summed over
        the ranks."""
        if w.shape[dim] == full:
            return self.copy(w)
        return self.gather_partial(w, dim)

    # -- the vocab-parallel embedding --------------------------------------------
    def vocab_embed(self, tok: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Rows of ``tokens`` from this rank's vocab range of the embedding
        ``tok`` (V / size, D), in the boundary's layout."""
        vl = tok.shape[0]
        lo = self.rank * vl
        here = (tokens >= lo) & (tokens < lo + vl)
        rows = tok[(tokens - lo).clamp(0, vl - 1)]
        rows = torch.where(here[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                              device=rows.device))
        return self.exit(rows, partial=True)


# -- serving: plain functions over a group, no backward ---------------------------
def vocab_argmax(logits: torch.Tensor, tp: TensorParallel | None, vocab: int) -> torch.Tensor:
    """The greedy token of each row of ``logits`` (..., V / size), this
    rank's slice of the vocab where the head splits over the model group
    (the whole vocab otherwise): each rank's (max, index) all-gathered, the
    largest value kept and, on ties, the lowest index, as ``torch.argmax``
    of the whole row. int64, equal on every rank of the group."""
    if tp is None or logits.shape[-1] == vocab:
        return torch.argmax(logits, dim=-1)
    idx = torch.argmax(logits, dim=-1)
    top = logits.gather(-1, idx[..., None])[..., 0]
    pair = torch.stack([top.double(), (idx + tp.rank * logits.shape[-1]).double()], dim=-1)
    every = _all_gather(pair[None], tp.group, tp.size, 0)  # (size, ..., 2), rank order
    first = torch.argmax(every[..., 0], dim=0, keepdim=True)  # lowest rank of the max
    return every[..., 1].gather(0, first)[0].to(torch.int64)


def gather_vocab(logits: torch.Tensor, tp: TensorParallel | None, vocab: int) -> torch.Tensor:
    """The whole-vocab logits from each rank's slice (``logits`` itself
    where the head is whole)."""
    if tp is None or logits.shape[-1] == vocab:
        return logits
    return _all_gather(logits, tp.group, tp.size, -1)


def gather_rows(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every rank's rows of ``x`` concatenated in rank order along dim 0: a
    data group's next tokens or logits for the slots each rank serves."""
    if size == 1:
        return x
    return _all_gather(x, group, size, 0)


class _Total(torch.autograd.Function):
    """The sum over the ranks, all-reduced forward and backward: every rank
    consumes the total alike, and the step averages the ranks' gradients,
    so each rank's addend takes the sum of the consumers' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


@dataclasses.dataclass(frozen=True)
class BatchGroup:
    """The ranks that hold other rows of one batch, ``rank`` of ``size``:
    rank r holds the r-th slice of each microbatch's rows
    (``dist/sharding.xla_batch_split``)."""

    group: object
    rank: int
    size: int

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, with the gradient of a term
        that every rank's loss holds once: the mean of the ranks'
        gradients (``train/sync.XlaSync.batch_mean``) counts it once."""
        return _Total.apply(x, self.group)

    def count_before(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the lower ranks (no gradient): this rank's
        offset in the batch's row order."""
        rows = _all_gather(x.detach()[None], self.group, self.size, 0)
        return rows[:self.rank].sum(dim=0)


def batch_group(mesh, plan) -> BatchGroup | None:
    """The batch group of the xla path's sharded layout on ``mesh``: the
    data group, or under ``dp_only`` every rank (None for one rank)."""
    if getattr(plan, "dp_only", False) and mesh.model > 1:
        return BatchGroup(mesh.group, mesh.rank, mesh.world)
    return BatchGroup(mesh.data_group, mesh.data_rank, mesh.data) if mesh.data > 1 else None


def make_tensor_parallel(mesh, plan) -> TensorParallel | None:
    """The step's model-axis view of ``mesh`` under ``plan``: None without
    a model axis or under ``dp_only``, which folds it into the batch."""
    if mesh.model == 1 or getattr(plan, "dp_only", False):
        return None
    return TensorParallel(mesh.model_group, mesh.model_rank, mesh.model,
                          bool(getattr(plan, "seq_shard_acts", False)))
