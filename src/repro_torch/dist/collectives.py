"""Gradient-sync collectives with wire-format compression and error feedback.

Port of ``src/repro/dist/collectives.py`` onto ``torch.distributed``. Two
compression levels for the gradient all-reduce:

  * ``bf16_all_reduce``: bf16 on the wire, mean across ranks;
  * ``compressed_all_reduce``: int8 with a per-tensor absmax scale and an
    error-feedback residual: each step sends ``quantize(g + err)`` and
    carries ``err' = (g + err) - dequantize(...)`` into the next.

Two sync paths consume them (``MemoryPlan.sync_mode``):

  * **xla**: GSPMD's reduction, then the wire numerics on the reduced
    gradients (``mesh=None`` in the reference). On one rank the reduction is
    the local math (``group=None``). On several ranks a sharded leaf's
    gradient comes out of the gather's backward reduce-scattered
    (``LazyGather`` with ``compress="none"``), a replicated leaf's is
    averaged by ``manual_mean``, and ``xla_int8_ef`` quantizes a shard with
    the scale of the whole leaf: its absmax is all-reduced (MAX) first, as
    the reference's ``max(|x|)`` over the logical tensor is under GSPMD.
  * **manual**: the step owns the reduction through the ``manual_*``
    functions, over a process group of the data-parallel ranks:

    - *replicated leaves* (DDP-style): each rank quantizes its local
      gradient plus its residual to int8, the int8 payload and the fp32
      scales are all-gathered, and every rank dequantizes and averages them
      in rank order (``manual_int8_ef_sync``);
    - *ZeRO-sharded leaves*: each rank chunks its local full gradient along
      the sharded dim, adds its shard-sized residual to its own chunk,
      quantizes per chunk with ``kernels.fused_quantize_ef`` and sends chunk
      j's int8 payload and scale to rank j with ``all_to_all_single``; the
      owner dequantizes and averages (``manual_int8_ef_reduce_scatter``).
      The residual is the error of the rank's own chunk only.

    ``gather_param_lazy`` completes ZeRO-3: a ``torch.autograd.Function``
    whose forward all-gathers a shard and whose backward is the compressed
    reduce-scatter, writing the new residual into the caller's residual
    tensor. ``LazyGather`` is the step's door to it, as ``models/offload.
    HostIO`` is for host weights: it gathers ahead (``async_op=True``),
    gathers again in the backward what a run does not buffer, and counts
    the gathers (``sync.param_gathers``, by chunk and whether it was
    started ahead).

Quantization divides by a tensor, where the reference divides: PyTorch on
CUDA divides by a Python scalar as a multiply by its reciprocal. A world of
one with no process group takes the local math (an all-gather of one is
the identity), so the manual code runs on one device alone too.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.compat import storage_key, tensor_key
from repro_torch import kernels as K
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.optim.adam import tree_leaves, tree_map

COMPRESS = ("none", "bf16", "int8_ef")


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _rank(group) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def _all_gather(t: torch.Tensor, group, async_op: bool = False):
    """(world, *t.shape): every rank's ``t`` in rank order, and the work
    (None unless ``async_op``). Gathered flat, as one concatenation: the
    form every backend takes."""
    if not dist.is_initialized():
        return t.detach().unsqueeze(0).clone(), None
    flat = t.detach().contiguous().reshape(-1)
    out = torch.empty(_world(group) * flat.numel(), dtype=t.dtype, device=t.device)
    work = dist.all_gather_into_tensor(out, flat, group=group, async_op=async_op)
    return out.view((_world(group),) + tuple(t.shape)), work


def _all_to_all(t: torch.Tensor, group, async_op: bool = False):
    """Chunk j of ``t`` (world, ...) goes to rank j; returns (out, work)."""
    if not dist.is_initialized():
        return t.clone(), None
    out = torch.empty_like(t)
    work = dist.all_to_all_single(out, t.contiguous(), group=group, async_op=async_op)
    return out, work


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of ``t``, in a new tensor (``t`` may be the
    caller's: ``.float()`` of an fp32 tensor is the tensor itself)."""
    t = t.clone()
    if dist.is_initialized():
        dist.all_reduce(t, group=group)
    return t


# ---------------------------------------------------------------------------
# bf16 and int8 + error feedback, all-reduce (collectives.py:78-131)
# ---------------------------------------------------------------------------
def _quantize_int8(x: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8: (q int8, scale fp32 scalar). ``group``: the
    ranks that hold the tensor's other shards, or a tuple of groups, one an
    axis the tensor is split on; the absmax is then the whole tensor's (a
    MAX all-reduce over each), so every shard takes one scale."""
    xf = x.float()
    amax = xf.abs().max()
    if group is not None and dist.is_initialized():
        for g in group if isinstance(group, tuple) else (group,):
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=g)
    amax = torch.clamp_min(amax, 1e-30)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def bf16_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean across the ranks of ``group`` with bf16 on the wire; returns x's
    dtype. ``group=None`` (the reference's ``mesh=None``): the bf16 round
    trip alone, the local math of one rank."""
    xb = x.to(torch.bfloat16)
    if group is None or _world(group) == 1:
        return xb.to(x.dtype)
    return manual_mean(xb, group).to(x.dtype)


def xla_int8_ef(x: torch.Tensor, err: torch.Tensor, group=None):
    """The xla path's int8 + EF numerics on this rank's part of a reduced
    gradient: ``compressed_all_reduce(x, err, mesh=None)`` of the whole
    leaf, restricted to the shard. ``group``: the ranks that hold the
    leaf's other shards (a tuple of groups for a leaf split over both
    axes), whose absmax is all-reduced (MAX) into the one per-tensor scale;
    None for a replicated leaf (every rank holds it whole). Returns
    ``(dequantized x, new_err)``."""
    c = x.float() + err.float()
    local = _dequantize_int8(*_quantize_int8(c, group))
    return local.to(x.dtype), (c - local).to(err.dtype)


def compressed_all_reduce(x: torch.Tensor, err: torch.Tensor, group=None):
    """Int8 error-feedback mean across the ranks of ``group`` (None: the
    local math). Returns ``(avg, new_err)``; on one rank ``avg + new_err ==
    x + err`` and ``|new_err|`` is at most half a quantization step."""
    c = x.float() + err.float()
    q, scale = _quantize_int8(c)
    local = _dequantize_int8(q, scale)
    new_err = c - local
    avg = local if group is None or _world(group) == 1 else manual_mean(local, group)
    return avg.to(x.dtype), new_err.to(err.dtype)


# ---------------------------------------------------------------------------
# Manual sync primitives (collectives.py:134-162)
# ---------------------------------------------------------------------------
def manual_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Uncompressed mean over the ranks (fp32 on the wire)."""
    return (_sum(x.float(), group) / _world(group)).to(x.dtype)


def manual_bf16_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean with bf16 on the wire: the sum of the bf16-cast local values."""
    return (_sum(x.to(torch.bfloat16), group) / _world(group)).to(x.dtype)


class Pending:
    """A sync whose collectives may still run: ``wait()`` returns its result
    (the deferred half of the overlapped schedule, ``train/sync.py``)."""

    def __init__(self, works: list, finish):
        self._works = [w for w in works if w is not None]
        self._finish = finish

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        return self._finish()


def manual_int8_ef_sync(x: torch.Tensor, err: torch.Tensor, group=None, *,
                        async_op: bool = False):
    """Int8 + EF mean over the ranks with the int8 payload on the wire:
    quantize ``x + err`` locally, all-gather the payload and the fp32
    scales, then every rank dequantizes and averages them in rank order
    (fp32, stacked, ``mean(0)``). Returns ``(mean in x's dtype, new_err)``;
    with ``async_op`` the mean is a ``Pending``."""
    c = x.float() + err.float()
    q, scale = _quantize_int8(c)
    new_err = (c - _dequantize_int8(q, scale)).to(err.dtype)
    qg, w1 = _all_gather(q, group, async_op)
    sg, w2 = _all_gather(scale, group, async_op)

    def finish():
        deq = qg.float() * sg.reshape((-1,) + (1,) * x.dim())
        return torch.mean(deq, dim=0).to(x.dtype)

    return (Pending([w1, w2], finish) if async_op else finish()), new_err


# ---------------------------------------------------------------------------
# Reduce-scatter to shard owners (collectives.py:186-298)
# ---------------------------------------------------------------------------
def _pad_dim(x: torch.Tensor, dim: int, z: int) -> torch.Tensor:
    """Zero-pad ``dim`` up to the next multiple of z. The step shards only
    dims that z divides (``dist/sharding._fits``); the primitives take any."""
    pad = (-x.shape[dim]) % z
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim)


def _chunk(x: torch.Tensor, dim: int, z: int) -> torch.Tensor:
    """(..., dim, ...) -> (z, ..., dim/z, ...), contiguous and in a new
    tensor, never a view of ``x`` (the int8 sync adds its residual into
    it): chunk j is rank j's shard."""
    x = _pad_dim(x, dim, z)
    s = x.shape[dim] // z
    parts = x.reshape(x.shape[:dim] + (z, s) + x.shape[dim + 1:])
    return parts.movedim(dim, 0).clone(memory_format=torch.contiguous_format)


def manual_reduce_scatter(x: torch.Tensor, group, dim: int, wire_dtype=None) -> torch.Tensor:
    """This rank's shard of the mean over the ranks of ``x`` along ``dim``
    (padded to a multiple of the world when uneven). ``wire_dtype`` casts
    the payload; the default keeps fp32."""
    z = _world(group)
    ch = _chunk(x.to(wire_dtype or torch.float32), dim, z)
    if dist.is_initialized():
        out = torch.empty(ch.shape[1:], dtype=ch.dtype, device=ch.device)
        dist.reduce_scatter_tensor(out.view(-1), ch.view(-1), group=group)  # flat: every backend
    else:
        out = ch[0]
    return (out.float() / z).to(x.dtype)


def manual_bf16_reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Mean reduce-scatter with bf16 on the wire."""
    return manual_reduce_scatter(x, group, dim, wire_dtype=torch.bfloat16)


def manual_int8_ef_reduce_scatter(x: torch.Tensor, err: torch.Tensor, group, dim: int, *,
                                  async_op: bool = False):
    """Int8 + EF mean reduce-scatter with the int8 payload on the wire.

    The rank splits its local full gradient into z chunks along ``dim``,
    adds its shard-sized residual to its own chunk, and quantizes every
    chunk with its absmax scale and its own chunk's residual in one
    ``kernels.fused_quantize_ef`` call; ``all_to_all_single`` sends chunk j's
    payload and scale to rank j, which dequantizes the z chunks it receives
    and averages them. Returns ``(shard mean in x's dtype, new_err)``, both
    shard-sized; the errors of the z-1 chunks sent away are dropped (at most
    half a step each). With ``async_op`` the mean is a ``Pending``."""
    z, me = _world(group), _rank(group)
    ch = _chunk(x.float(), dim, z)
    ch[me] += err.float()
    q, scale, new_err = K.fused_quantize_ef(ch, me)
    qr, w1 = _all_to_all(q, group, async_op)
    sr, w2 = _all_to_all(scale, group, async_op)

    def finish():
        deq = qr.float() * sr.reshape((z,) + (1,) * (qr.dim() - 1))
        return torch.mean(deq, dim=0).to(x.dtype)

    return (Pending([w1, w2], finish) if async_op else finish()), new_err.to(err.dtype)


def sync_reduce_scatter(g: torch.Tensor, err, group, dim: int, compress: str, *,
                        async_op: bool = False):
    """The reduce-scatter of one gradient under ``compress``: (shard, new
    residual or ``err`` unchanged); with ``async_op`` an int8 shard may be a
    ``Pending``."""
    if compress == "int8_ef":
        return manual_int8_ef_reduce_scatter(g, err, group, dim, async_op=async_op)
    if compress == "bf16":
        return manual_bf16_reduce_scatter(g, group, dim), err
    return manual_reduce_scatter(g, group, dim), err


# ---------------------------------------------------------------------------
# Lazy per-chunk param gather (collectives.py:301-369)
# ---------------------------------------------------------------------------
def _tiled(parts: torch.Tensor, dim: int) -> torch.Tensor:
    """(z, *shard) shards -> the full leaf, concatenated along ``dim``."""
    full = list(parts.shape[1:])
    full[dim] *= parts.shape[0]
    return parts.movedim(0, dim).reshape(full)


def tiled_all_gather(w: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The full leaf from every rank's shard ``w``, along ``dim``."""
    return _tiled(_all_gather(w, group)[0], dim)


class _GatherParam(torch.autograd.Function):
    """The full leaf from shard ``w`` (or from ``src``, the shard in host
    memory ``w`` stands in for); the backward reduce-scatters the cotangent
    to shard owners and writes the new residual into ``err``."""

    @staticmethod
    def forward(ctx, w, err, group, dim, compress, lazy, src):
        ctx.err, ctx.group, ctx.dim, ctx.compress = err, group, dim, compress
        src = w if src is None else src
        return lazy.gather(src) if lazy is not None else tiled_all_gather(src, group, dim)

    @staticmethod
    def backward(ctx, ct):
        g, new_err = sync_reduce_scatter(ct, ctx.err, ctx.group, ctx.dim, ctx.compress)
        if ctx.compress == "int8_ef":
            ctx.err.copy_(new_err)
        return g, None, None, None, None, None, None


def gather_param_lazy(w: torch.Tensor, err: torch.Tensor | None, group, dim: int,
                      compress: str = "int8_ef", lazy: "LazyGather | None" = None,
                      src: torch.Tensor | None = None):
    """Just-in-time all-gather of this rank's shard ``w`` along ``dim``,
    whose backward is the compressed reduce-scatter: the rank receives only
    its shard's gradient, with the int8 payload on the wire. ``err`` (the
    shard-sized fp32 residual under ``int8_ef``, else None) is unused in
    the forward; the backward overwrites it with the new residual, the
    state the caller carries keyed by chunk. ``lazy``: the step's
    ``LazyGather``, which may hold the gather started ahead. ``src``: the
    shard in host memory that ``w`` (its device proxy, which takes the
    gradient) stands in for."""
    if compress not in COMPRESS:
        raise ValueError(f"compress={compress!r} not in {COMPRESS}")
    if compress == "int8_ef" and err is None:
        raise ValueError("int8_ef needs the shard's residual")
    return _GatherParam.apply(w, err, group, dim, compress, lazy, src)


class _Regather:
    """A gathered weight dropped after the forward: gathered again on first
    use in the backward, then viewed as it was saved."""

    def __init__(self, lazy: "LazyGather", w: torch.Tensor):
        self.lazy, self.w, self.full = lazy, w, None

    def get(self) -> torch.Tensor:
        if self.full is None:
            self.full = self.lazy.gather(self.w)
        return self.full


class LazyGather:
    """A step's gathers of ZeRO shards: the manual ``zero3`` dataflow
    (``compress`` its wire format) and the xla path on several ranks
    (``compress="none"``: the wire numerics apply after the reduction).

    ``register(shard, dim, err, chunk, host)`` names a shard (a tensor or a
    stacked run's per-repeat view, found again by its address, ``tensor_key``), the dim
    it gathers along, its residual, its chunk's label and whether it lies
    in host memory: then ``io`` (the step's ``models/offload.HostIO``)
    copies it to the device before the all-gather, and a replicated host
    leaf (``dim`` None) is only copied. The model takes the same calls from
    it as from ``HostIO``: ``fetch`` (gather, differentiable into the shard
    or its device proxy), ``prefetch`` (start a later unit's reads: host
    copies always, through ``io``; with ``gather`` the all-gathers of
    device shards, ``async_op=True``), ``refetch_saved`` (what autograd
    saves of a gathered weight is dropped and gathered again in the
    backward: an unbuffered chunk) and ``will_fetch_again``. A device leaf
    that was not registered (replicated) passes through unchanged. Every
    rank issues the same collectives in the same order: the program order
    of the forward and the backward, with host copies ahead on ``io``'s
    side stream and each all-gather of a host shard at its point of use."""

    def __init__(self, group, compress: str, registry=NULL_REGISTRY, io=None):
        self.group, self.compress, self.registry, self.io = group, compress, registry, io
        self._leaves: dict[tuple, tuple[int | None, torch.Tensor | None, str, bool]] = {}
        self._pending: dict[tuple, tuple[torch.Tensor, object]] = {}

    def register(self, w: torch.Tensor, dim: int | None, err: torch.Tensor | None,
                 chunk: str, host: bool = False) -> None:
        if dim is not None or host:
            self._leaves[tensor_key(w)] = (dim, err, chunk, host)

    def _hosts(self, tree) -> list:
        """The registered host leaves of ``tree``."""
        return [w for w in tree_leaves(tree)
                if tensor_key(w) in self._leaves and self._leaves[tensor_key(w)][3]]

    def will_fetch_again(self, tree) -> None:
        """The model's notice that the backward gathers ``tree`` again: a
        regather runs where the backward first reads the weight; its host
        copies are recorded with ``io``, which starts them a unit ahead."""
        hosts = self._hosts(tree)
        if hosts:
            self.io.will_fetch_again(hosts)

    def _count(self, w: torch.Tensor, chunk: str, ahead: bool) -> None:
        self.registry.counter("sync.param_gathers", chunk=chunk, ahead=ahead).inc()
        self.registry.counter("sync.param_gather_bytes").inc(
            w.numel() * w.element_size() * _world(self.group))

    def gather(self, w: torch.Tensor) -> torch.Tensor:
        """The full leaf of registered shard ``w`` on the device (no
        gradient): the prefetched gather once it is done, else one now (a
        host shard copied to the device first)."""
        dim, _, chunk, host = self._leaves[tensor_key(w)]
        if dim is None:
            return self.io.take(w)
        hit = self._pending.pop(tensor_key(w), None)
        if hit is None:
            self._count(w, chunk, ahead=False)
            return tiled_all_gather(self.io.take(w) if host else w, self.group, dim)
        out, work = hit
        if work is not None:
            work.wait()
        return _tiled(out, dim)

    def prefetch(self, tree, gather: bool = True) -> None:
        hosts = self._hosts(tree)
        if hosts:
            self.io.prefetch(hosts)
        if not gather:
            return
        for w in tree_leaves(tree):
            key = tensor_key(w)
            entry = self._leaves.get(key)
            if entry is not None and entry[0] is not None and not entry[3] \
                    and key not in self._pending:
                self._count(w, entry[2], ahead=True)
                self._pending[key] = _all_gather(w, self.group, async_op=True)

    def fetch(self, proxies, shards):
        """Gathered weights of the tree ``shards``, differentiable into the
        same tree ``proxies``: the shards themselves where they lie on the
        device, their device proxies where they lie in host memory."""
        def one(px, w):
            entry = self._leaves.get(tensor_key(w))
            if entry is None:
                return w
            dim, err, _, host = entry
            if dim is None:
                return self.io.fetch(px, w)
            return gather_param_lazy(px, err, self.group, dim, self.compress, lazy=self,
                                     src=w if host else None)
        return tree_map(one, proxies, shards)

    def refetch_saved(self, fetched, shards) -> torch.autograd.graph.saved_tensors_hooks:
        """Saved-tensor hooks under which what autograd saves of a gathered
        weight in ``fetched`` is not kept: the backward gathers it again."""
        self.will_fetch_again(shards)
        by_storage = {}
        for full, w in zip(tree_leaves(fetched), tree_leaves(shards)):
            if tensor_key(w) in self._leaves:
                by_storage[full.device, storage_key(full)] = _Regather(self, w)

        def pack(t):
            ref = by_storage.get((t.device, storage_key(t)))
            return t if ref is None else (ref, t.size(), t.stride(), t.storage_offset())

        def unpack(obj):
            if isinstance(obj, torch.Tensor):
                return obj
            ref, size, stride, offset = obj
            return ref.get().as_strided(size, stride, offset)

        return torch.autograd.graph.saved_tensors_hooks(pack, unpack)


class ServeGather:
    """The serving twin of the reference's ``gather_weights`` (its decode
    scan, ``models/kvcache.py:238-278``): under a serve plan whose chunks
    are not all persistent, a rank holds its data slice of every
    non-persistent leaf (``dist/sharding.serve_shards``), and each step
    makes them whole over the data group -- the embedding, final norm,
    head and encoder once a step (``outer``), each layer's weights through
    the ``LazyGather`` of the xla path, its all-gather started one layer
    ahead (``prefetch``, then ``layer``). Nothing is kept between steps:
    the device holds the rank's shards and at most two gathered layers.
    The layers' gathers count as ``sync.param_gathers{chunk="blocks",
    ahead}``. Every rank of the group issues the same gathers in one
    order."""

    def __init__(self, group, registry=NULL_REGISTRY):
        self.group = group
        self.lazy = LazyGather(group, "none", registry)
        self._outer: dict[tuple, int] = {}  # a leaf (tensor_key) -> the dim it gathers along

    def register(self, params: dict, dims: dict) -> None:
        """Name the sharded leaves of a rank's ``params`` (the serve tree)
        by their data dims ``dims`` (the same tree of ints or None): each
        block leaf per repeat (its stacked dim less one), the others
        whole."""
        for key, sub in params.items():
            for t, d in zip(tree_leaves(sub), tree_leaves_dims(dims[key])):
                if d is None:
                    continue
                if key == "blocks":
                    for r in range(t.shape[0]):
                        self.lazy.register(t[r], d - 1, None, "blocks")
                else:
                    self._outer[tensor_key(t)] = d

    def outer(self, params: dict) -> dict:
        """``params`` with every leaf outside the layer stack whole."""
        def one(t):
            d = self._outer.get(tensor_key(t))
            return t if d is None else tiled_all_gather(t, self.group, d)
        return {k: v if k == "blocks" else tree_map(one, v) for k, v in params.items()}

    def prefetch(self, layer: dict) -> None:
        """Start the all-gathers of a layer's leaves (a per-repeat tree)."""
        self.lazy.prefetch(layer)

    def layer(self, layer: dict) -> dict:
        """A layer's weights whole over the data group: each leaf's
        prefetched gather once it is done, else one now."""
        known = self.lazy._leaves
        return tree_map(lambda w: self.lazy.gather(w) if tensor_key(w) in known else w, layer)


def tree_leaves_dims(dims) -> list:
    """The leaves of a tree of dims (ints or None), in ``tree_leaves`` order."""
    if dims is None or isinstance(dims, int):
        return [dims]
    if isinstance(dims, dict):
        return [x for k in sorted(dims) for x in tree_leaves_dims(dims[k])]
    return [x for v in dims for x in tree_leaves_dims(v)]


# ---------------------------------------------------------------------------
# Tree variants (collectives.py:372-389)
# ---------------------------------------------------------------------------
def init_error_feedback(grads, device=None):
    """fp32 zero residuals matching a gradient tree (on ``device``, default
    each leaf's)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=device or g.device), grads)
