"""Host memory on the training path: host-resident weights and swapped
activations.

``HostIO`` is the step's one door to host memory. It brings a ``host``
chunk's weights to the device (``host_params=True``: the weights live in
pinned memory, as ``gather_weights`` / ``fetch`` move them in
``src/repro/models/model.py:269-294`` and ``src/repro/train/step_builder.py:
286-310``) and takes a ``swap`` layer's saved activations to pinned memory
and back (the ``save_and_offload_only_these_names`` arm of
``_remat_policy``, ``model.py:440-446``). Copies to the device can run ahead
on a side stream (``prefetch``: the layer stack fetches one repeat ahead);
copies off the device always run there. The backward's own reads (weights
fetched again, swapped activations back) run one unit ahead there too: the
forward records, per unit of the layer stack (``begin_unit``), what its
backward will read, and once the backward (``begin_backward``) reaches a
unit's first read, the next unit's reads are started on the side stream.
Every copy is stream-ordered: the
side stream waits for the work that produced its source, the consumer
waits for the copy's event, and a device tensor read by the side stream is
recorded on it so the allocator does not hand its memory out before the
copy is done. On a CPU device the host is the device: copies are plain
clones, so the CPU tests run the same paths.

Gradients of host weights. Autograd needs a leaf on the device for each
host weight, so the step gives each one a *proxy*: a zero-byte (expanded)
tensor of the weight's shape, dtype and device that requires grad.
``fetch`` returns the device copy as a function of the proxy (``_Fetch``),
so the weight's gradient lands on the proxy, on the device. A host chunk's
gradient thus takes the same device bytes as any other chunk's (its bf16
size, or fp32 while microbatches accumulate); its bf16 weights and fp32
optimizer states stay in pinned memory, where the Adam kernel updates them.

On several data ranks (the xla path's sharded layouts) a host chunk's
pinned leaves are this rank's shards: ``dist.collectives.LazyGather``
takes each through ``take`` (prefetched a repeat ahead, as here) and then
all-gathers it, and the gather's backward reduce-scatters the gradient onto
the shard's device proxy; swapped sites go to this rank's pinned memory
unchanged.

Counters (``train.*`` in the telemetry registry): ``train.weight_fetch_bytes``
(every host-to-device weight copy, prefetched or not, forward or backward),
``train.act_swap_out_bytes`` and ``train.act_swap_in_bytes``; beside them
``train.act_quantize_launches``, the activation quantizer's calls, which the
``compress8`` sites of ``models/model.py`` count here.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.compat import faking, pinned_empty, storage_key, tensor_key
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.optim.adam import tree_leaves, tree_map


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def proxy_like(t: torch.Tensor, device) -> torch.Tensor:
    """A zero-byte leaf of ``t``'s shape and dtype on ``device`` that
    requires grad: the autograd stand-in for the host tensor ``t``."""
    return torch.zeros((), dtype=t.dtype, device=device).expand(t.shape).requires_grad_()


class _Fetch(torch.autograd.Function):
    """The device copy of host weight ``host``; its gradient goes to
    ``proxy`` (same shape, on the device)."""

    @staticmethod
    def forward(ctx, proxy, host, io):
        return io.take(host)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


@dataclasses.dataclass
class SwappedAct:
    """An activation saved in host memory; ``event`` marks the end of its
    copy off the device (None on a CPU device); ``unit`` is the layer-stack
    unit that saved it; ``ahead``, its copy back started early (device
    tensor, event)."""

    host: torch.Tensor
    event: torch.cuda.Event | None
    unit: int = -1
    ahead: tuple[torch.Tensor, torch.cuda.Event] | None = None


class _Refetch:
    """A saved weight dropped after the forward: fetched again on first use
    in the backward, then viewed as it was saved."""

    def __init__(self, io: "HostIO", host: torch.Tensor):
        self.io, self.host, self.dev = io, host, None

    def get(self) -> torch.Tensor:
        if self.dev is None:
            self.dev = self.io.take(self.host)
        return self.dev


class HostIO:
    """Copies between pinned host memory and ``device`` for one training
    step (see the module docstring); ``registry`` receives its counters."""

    def __init__(self, device, registry=NULL_REGISTRY):
        self.device = torch.device(device)
        # no side stream on a fake CUDA device (the dry-run): copies run in place
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" and not faking() else None)
        self.fetched = registry.counter("train.weight_fetch_bytes")
        self.swapped_out = registry.counter("train.act_swap_out_bytes")
        self.swapped_in = registry.counter("train.act_swap_in_bytes")
        self.quantized = registry.counter("train.act_quantize_launches")
        self._pending: dict[tuple, tuple[torch.Tensor, torch.cuda.Event]] = {}
        self.reset()

    def reset(self) -> None:
        """Drop prefetched copies that were never taken, and the record of
        what the backward reads: a new microbatch starts."""
        self._pending.clear()
        self._unit = -1
        self._reads: list[tuple[list, list]] = []  # per unit: (host weight trees, swaps)
        self._host_unit: dict[tuple, int] = {}  # host weight (tensor_key) -> unit
        self._backward = False
        self._started: set[int] = set()

    # ---- the backward's reads, one unit ahead --------------------------------------
    def begin_unit(self) -> None:
        """The forward enters the next unit of the layer stack."""
        self._unit += 1
        self._reads.append(([], []))

    def will_fetch_again(self, hosts) -> None:
        """The current unit's backward fetches the host tree ``hosts`` again."""
        if self._unit < 0:
            return
        self._reads[self._unit][0].append(hosts)
        for t in tree_leaves(hosts):
            self._host_unit[tensor_key(t)] = self._unit

    def begin_backward(self) -> None:
        """The forward is over: start the reads of the last unit that has any."""
        self._backward = True
        self._start_before(len(self._reads))

    def _reached(self, unit: int) -> None:
        """The backward reads from ``unit``: start the next unit's reads."""
        if self._backward and unit >= 0 and unit not in self._started:
            self._started.add(unit)
            self._start_before(unit)

    def _start_before(self, unit: int) -> None:
        for u in range(unit - 1, -1, -1):
            weights, swaps = self._reads[u]
            if not (weights or swaps):
                continue
            for tree in weights:
                self.prefetch(tree)
            for saved in swaps:
                self._swap_in_ahead(saved)
            return

    # ---- weights ------------------------------------------------------------
    def prefetch(self, tree) -> None:
        """Start copying every leaf of the host tree ``tree`` to the device
        on the side stream (a no-op on a CPU device)."""
        if self.stream is None:
            return
        leaves = [t for t in tree_leaves(tree) if tensor_key(t) not in self._pending]
        if not leaves:
            return
        # the side stream follows the work already queued: the update that
        # last wrote these host weights
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        copies = []
        with torch.cuda.stream(self.stream):
            for t in leaves:
                copies.append(torch.empty(t.shape, dtype=t.dtype, device=self.device)
                              .copy_(t, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self.stream)
        for t, dev in zip(leaves, copies):
            self._pending[tensor_key(t)] = (dev, event)

    def take(self, host: torch.Tensor) -> torch.Tensor:
        """The device copy of the host tensor ``host``: the prefetched one
        once its copy is done, else a copy queued now."""
        self.fetched.inc(_nbytes(host))
        self._reached(self._host_unit.get(tensor_key(host), -1))
        hit = self._pending.pop(tensor_key(host), None) if self.stream is not None else None
        if hit is None:
            return torch.empty(host.shape, dtype=host.dtype, device=self.device).copy_(
                host, non_blocking=True)
        dev, event = hit
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(event)
        dev.record_stream(cur)
        return dev

    def fetch(self, proxies, hosts):
        """Device copies of the host tree ``hosts``, differentiable into the
        matching tree of ``proxies``."""
        return tree_map(lambda px, h: _Fetch.apply(px, h, self), proxies, hosts)

    def refetch_saved(self, fetched, hosts) -> torch.autograd.graph.saved_tensors_hooks:
        """Saved-tensor hooks under which a tensor that autograd saves from
        the fetched tree ``fetched`` (copies of ``hosts``) is not kept: the
        backward fetches it again. The unbuffered weights of a layer that
        keeps its activations (``_remat_policy("none", buffered=False)``)."""
        # keyed by the fetched copies' own devices (``cuda:0``), which a
        # saved tensor reports whatever index ``self.device`` was given with
        self.will_fetch_again(hosts)
        by_storage = {}
        for dev, host in zip(tree_leaves(fetched), tree_leaves(hosts)):
            by_storage[dev.device, storage_key(dev)] = _Refetch(self, host)

        def pack(t):
            ref = by_storage.get((t.device, storage_key(t)))
            return t if ref is None else (ref, t.size(), t.stride(), t.storage_offset())

        def unpack(obj):
            if isinstance(obj, torch.Tensor):
                return obj
            ref, size, stride, offset = obj
            return ref.get().as_strided(size, stride, offset)

        return torch.autograd.graph.saved_tensors_hooks(pack, unpack)

    # ---- activations ----------------------------------------------------------
    @torch.no_grad()
    def swap_out(self, x: torch.Tensor) -> SwappedAct:
        """Copy ``x`` to pinned host memory on the side stream."""
        self.swapped_out.inc(_nbytes(x))
        if self.stream is None:  # a CPU device, or a fake CUDA one: to host memory
            host = x.detach().clone() if self.device.type == "cpu" else x.detach().cpu()
            return SwappedAct(host, None, self._unit)
        host = pinned_empty(x.shape, x.dtype)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            host.copy_(x, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        x.record_stream(self.stream)  # x may be freed while the copy still reads it
        saved = SwappedAct(host, event, self._unit)
        if self._unit >= 0:
            self._reads[self._unit][1].append(saved)
        return saved

    def _swap_in_ahead(self, saved: SwappedAct) -> None:
        """Start copying ``saved`` back to the device on the side stream."""
        if self.stream is None or saved.event is None or saved.ahead is not None:
            return
        self.stream.wait_event(saved.event)
        with torch.cuda.stream(self.stream):
            dev = saved.host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        saved.ahead = (dev, event)

    @torch.no_grad()
    def swap_in(self, saved: SwappedAct) -> torch.Tensor:
        """The swapped activation back on the device, after its copy out."""
        self.swapped_in.inc(_nbytes(saved.host))
        self._reached(saved.unit)
        if saved.event is None:
            return saved.host.to(self.device, copy=True)
        cur = torch.cuda.current_stream(self.device)
        if saved.ahead is not None:
            dev, event = saved.ahead
            saved.ahead = None
            cur.wait_event(event)
            dev.record_stream(cur)
            return dev
        cur.wait_event(saved.event)
        return saved.host.to(self.device, non_blocking=True)
