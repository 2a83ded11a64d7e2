"""Memory-aware profiler (paper §3.2): one superblock forward, traced.

Port of ``src/repro/core/profiler.py``. The reference walks a jaxpr; here
the forward runs on **fake tensors** (``FakeTensorMode``: shapes, dtypes and
storages, no data, no allocation) under a ``TorchDispatchMode`` that sees
every aten op the forward reaches -- nothing is unhookable at that level
either. The fake tensors are CPU tensors, so the kernels package routes
every call to its **plain version** (``kernels/__init__._route``): the
profile counts the plain PyTorch forward, never a CUDA kernel, and comes out
the same on a machine with a card as without one.

Per op (``OpRecord``): FLOPs, bytes in and out, transient bytes and the live
set after it. FLOPs: matmuls (``mm``, ``bmm``, ``addmm``, ``baddbmm``)
exactly, 2·m·n·k; every other op one per output element (the reference's
rule, ``profiler.py:142-147``), zero for views, copies and constants.
Views (an output sharing an input's storage) move no bytes and allocate
nothing. Liveness is replayed over storages: an output storage is live from
the op that makes it to the last op that reads it. Residuals that autograd
would save, as the reference classifies them: the inputs of matmuls and of
the nonlinear ops (``_NONLINEAR``), each storage once, split into weights
(the storages of the weight arguments) and activations; ``_Recorder`` says
how the port's widening copies, norm statistics and broadcast products are
read as the reference's dots. A Python loop the reference writes as a
``lax.scan`` (the blockwise attention's KV blocks, marked by
``layers.scan_iteration``) adds its FLOPs and bytes every iteration but its
residuals once, as the reference's walk of a scan body does
(``profiler.py:113-115``): what a later iteration makes and saves stands
for the first iteration's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# aten ops whose backward needs their inputs (the reference's _NONLINEAR:
# exp, log, tanh, logistic, erf, rsqrt, sqrt, sin, cos, pow, max, min, div,
# rem, cumsum and the custom-JVP activations)
_NONLINEAR = {
    "exp", "exp2", "log", "log1p", "tanh", "sigmoid", "erf", "rsqrt", "sqrt", "sin", "cos",
    "pow", "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "div", "remainder",
    "fmod", "cumsum", "silu", "gelu", "relu", "_softmax", "_log_softmax",
}
# matmuls, and the norms' statistics counted as the reference's einsum (_Recorder)
MATMUL_OPS = {"mm", "bmm", "addmm", "baddbmm"}
CONTRACTIONS = MATMUL_OPS | {"contraction"}
# ops that need workspace beyond their output (the paper's intra-op spike)
_TRANSIENT = {"sort", "topk", "gather", "index", "index_select", "scatter", "scatter_add",
              "scatter_reduce", "index_put", "index_add", "cat"}
# ops that compute nothing: copies, casts, constants (views are found by storage)
_ZERO_FLOP = {"_to_copy", "clone", "copy_", "copy", "arange", "empty", "empty_like",
              "empty_strided", "new_empty", "new_empty_strided", "lift_fresh", "lift_fresh_copy",
              "scalar_tensor", "_local_scalar_dense"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _matmul_flops(name: str, args) -> float:
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else (args[0], args[1])
    batch = a.shape[0] if a.dim() == 3 else 1
    m, k = a.shape[-2], a.shape[-1]
    return 2.0 * batch * m * b.shape[-1] * k


@dataclasses.dataclass
class OpRecord:
    name: str  # the aten op (``mm``, ``add``, ...)
    flops: float
    bytes_in: int
    bytes_out: int
    transient_bytes: int
    live_bytes: int  # live set after this op (liveness replay)


@dataclasses.dataclass
class TraceProfile:
    ops: list[OpRecord]
    peak_live_bytes: int  # on-demand liveness peak (no residual persistence)
    total_flops: float
    total_bytes: int  # HBM traffic proxy: sum of in+out per op
    residual_act_bytes: int  # autograd residuals from activations
    residual_weight_bytes: int  # autograd residuals that are raw weights
    largest_op_bytes: int

    @property
    def matmul_flops(self) -> float:
        return sum(op.flops for op in self.ops if op.name in CONTRACTIONS)

    def summary(self) -> dict:
        return {
            "ops": len(self.ops),
            "gflops": self.total_flops / 1e9,
            "traffic_gb": self.total_bytes / 1e9,
            "peak_live_mb": self.peak_live_bytes / 1e6,
            "resid_act_mb": self.residual_act_bytes / 1e6,
        }


@dataclasses.dataclass
class _Event:
    name: str
    flops: float
    bytes_in: int
    bytes_out: int
    transient: int
    reads: list[int]  # input storages
    new: dict[int, int]  # storages this op allocates -> bytes


class _Recorder(TorchDispatchMode):
    """Records every aten op of a forward on fake tensors.

    Three rules make the port's plain ops read as the reference's jaxpr:

    * a widening copy (bf16 to fp32) feeding a matmul is how the port
      writes a dot with fp32 accumulation (``preferred_element_type``), so
      that residual is the tensor before widening (its ``origin``);
    * a last-axis ``sum`` / ``mean`` of widened data (or of the product of
      widened tensors) is the norms' statistic, which the reference writes
      as an einsum (``layers.rmsnorm``, ``layernorm``): it is counted as
      that contraction, ``"contraction"``, 2 FLOPs an input element;
    * a product ``layers.broadcast_dot`` makes (``note_dot``, which
      ``_noting_broadcast_dots`` calls while ``profile_fn`` records) is a
      dot the reference's einsum emits with no contracted axis: a
      contraction of 2 FLOPs an output element.
    """

    def __init__(self, weights: set[int]):
        super().__init__()
        self.weights = weights
        self.events: list[_Event] = []
        self.resid: dict[int, tuple[str, int]] = {}
        self.seen: set[int] = set()
        self.origin: dict[int, tuple[int, int]] = {}  # copy -> (source storage, bytes)
        self.widened: set[int] = set()
        self.products: dict[int, int] = {}  # storage of a product of widened data -> event
        self.made: dict[int, tuple] = {}  # output storage -> (event, [(input, its storage)])
        self.keep: list = []  # fake tensors stay referenced: storage ids stay unique
        self.loop_iter: int | None = None  # the iteration of a scan-body loop, inside one
        self.loop_made: set[int] = set()  # storages made inside such a loop

    def _resid(self, dot: bool, t: torch.Tensor, st: int) -> None:
        """Record a residual: a dot's input is its tensor before widening,
        and is a weight when that lies in a weight argument's storage."""
        nbytes = _nbytes(t)
        if dot:
            st, nbytes = self.origin.get(st, (st, nbytes))
        if self.loop_iter and st in self.loop_made:
            return  # a later iteration's: the body's residuals count once
        if st not in self.resid:
            self.resid[st] = ("w" if dot and st in self.weights else "a", nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [a for a in tree_flatten((args, kwargs or {}))[0] if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        if not outs:
            return out
        self.keep += ins + outs
        name = func.overloadpacket.__name__
        in_st = [_storage(t) for t in ins]
        aliased = func.is_view or any(_storage(o) in in_st for o in outs)
        if aliased and not name.endswith("_"):  # a view: no bytes, no work
            self.events.append(_Event(name, 0.0, 0, 0, 0, in_st, {}))
            return out
        in_b = sum(_nbytes(t) for t in ins)
        out_b = sum(_nbytes(o) for o in outs)
        if name in MATMUL_OPS:
            flops = _matmul_flops(name, args)
        elif name in _ZERO_FLOP:
            flops = 0.0
        else:
            flops = float(out_b // max(outs[0].element_size(), 1))
        new = {}
        for o in outs:
            st = _storage(o)
            if st not in self.seen and st not in in_st:
                new[st] = o.untyped_storage().nbytes()
        self.seen.update(new)
        if self.loop_iter is not None:
            self.loop_made.update(new)
        out_st = _storage(outs[0])
        if name in ("_to_copy", "clone") and len(ins) == 1:
            src, dst = ins[0], outs[0]
            if dst.element_size() >= src.element_size():  # widening or a plain copy
                self.origin[out_st] = self.origin.get(in_st[0], (in_st[0], _nbytes(src)))
                if dst.dtype == torch.float32 and src.dtype in (torch.bfloat16, torch.float16):
                    self.widened.add(out_st)
                elif in_st[0] in self.widened:
                    self.widened.add(out_st)
        if name == "mul" and len(ins) == 2 and all(st in self.widened for st in in_st):
            self.products[out_st] = len(self.events)
        if name in ("sum", "mean") and _last_axis(args) and in_st:
            if in_st[0] in self.products:  # sum of x * x: the product is the contraction
                i = self.products[in_st[0]]
                ev = self.events[i]
                self.events[i] = dataclasses.replace(ev, name="contraction", flops=2.0 * ev.flops)
                for st_in in ev.reads:
                    self._resid(True, ins[0], st_in)
            elif in_st[0] in self.widened:  # sum of x: x contracted with ones
                name, flops = "contraction", 2.0 * ins[0].numel()
                self._resid(True, ins[0], in_st[0])
        if name in MATMUL_OPS or name in _NONLINEAR:
            for t, st in zip(ins, in_st):
                self._resid(name in MATMUL_OPS, t, st)
        transient = out_b if name in _TRANSIENT else 0
        self.made[out_st] = (len(self.events), [(t, st) for t, st in zip(ins, in_st)])
        self.events.append(_Event(name, flops, in_b, out_b, transient, in_st, new))
        return out

    def note_dot(self, out: torch.Tensor) -> None:
        """``layers.broadcast_dot`` made ``out``: count the product that made
        it as the reference's dot with no contracted axis, a contraction of
        2 FLOPs an output element whose inputs are dot residuals."""
        i, ins = self.made[_storage(out)]
        ev = self.events[i]
        self.events[i] = dataclasses.replace(ev, name="contraction", flops=2.0 * ev.flops)
        for t, st in ins:
            self._resid(True, t, st)


def _last_axis(args) -> bool:
    """Does a ``sum`` / ``mean`` call reduce exactly the last axis?"""
    x = args[0]
    dims = args[1] if len(args) > 1 else None
    if dims is None:
        return False
    dims = [dims] if isinstance(dims, int) else list(dims)
    return len(dims) == 1 and dims[0] % x.dim() == x.dim() - 1


def _replay(events: list[_Event], live: dict[int, int], final: set[int]):
    """Liveness replay over storages -> (ops, peak, largest op bytes)."""
    last_use: dict[int, int] = {}
    for i, ev in enumerate(events):
        for st in ev.reads:
            last_use[st] = i
    for st in final:
        last_use[st] = len(events)
    cur = sum(live.values())
    peak, largest = cur, 0
    ops = []
    for i, ev in enumerate(events):
        live.update(ev.new)
        cur += sum(ev.new.values())
        peak = max(peak, cur + ev.transient)
        largest = max(largest, ev.bytes_in + ev.bytes_out + ev.transient)
        ops.append(OpRecord(ev.name, ev.flops, ev.bytes_in, ev.bytes_out, ev.transient, cur))
        for st in [s for s in live if last_use.get(s, -1) <= i]:
            cur -= live.pop(st)
    return ops, peak, largest


@contextlib.contextmanager
def _noting_broadcast_dots(rec: _Recorder):
    """While recording, ``layers.broadcast_dot`` notes each product it makes
    with ``rec``."""
    from repro_torch.models import layers as L

    plain = L.broadcast_dot

    def noted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        out = plain(a, b)
        rec.note_dot(out)
        return out

    L.broadcast_dot = noted
    try:
        yield
    finally:
        L.broadcast_dot = plain


@contextlib.contextmanager
def _counting_scan_bodies(rec: _Recorder):
    """While recording, ``layers.scan_iteration`` tells ``rec`` which
    iteration of a scan-body loop runs."""
    from repro_torch.models import layers as L

    plain = L.scan_iteration

    @contextlib.contextmanager
    def marked(i: int):
        outer, rec.loop_iter = rec.loop_iter, i
        try:
            yield
        finally:
            rec.loop_iter = outer

    L.scan_iteration = marked
    try:
        yield
    finally:
        L.scan_iteration = plain


def profile_fn(fn: Callable, *args, weight_args: tuple[int, ...] = ()) -> TraceProfile:
    """Trace ``fn(*args)`` -- fake tensors, under ``FakeTensorMode`` -- and
    profile its aten ops. ``weight_args``: positions of the arguments that
    are model weights (their residuals are classified as weight-derived)."""
    weights = {_storage(t) for i in weight_args for t in tree_flatten(args[i])[0]
               if isinstance(t, torch.Tensor)}
    inputs = [t for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor)]
    rec = _Recorder(weights)
    with torch.no_grad(), _noting_broadcast_dots(rec), _counting_scan_bodies(rec), rec:
        out = fn(*args)
    final = {_storage(t) for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)}
    live = {_storage(t): t.untyped_storage().nbytes() for t in inputs}
    ops, peak, largest = _replay(rec.events, live, final)
    return TraceProfile(
        ops=ops,
        peak_live_bytes=int(peak),
        total_flops=float(sum(op.flops for op in ops)),
        total_bytes=int(sum(op.bytes_in + op.bytes_out for op in ops)),
        residual_act_bytes=int(sum(b for k, b in rec.resid.values() if k == "a")),
        residual_weight_bytes=int(sum(b for k, b in rec.resid.values() if k == "w")),
        largest_op_bytes=int(largest),
    )


# ---------------------------------------------------------------------------
# Block-level profile: what the cost/memory models consume
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BlockProfile:
    """Per-superblock forward statistics for one microbatch."""

    flops_fwd: float
    hbm_bytes_fwd: float
    act_residual_bytes: int  # saved residuals under 'none' policy
    boundary_bytes: int  # block input (B,S,D) -- the 'checkpoint'/'swap' residual
    peak_transient_bytes: int  # workspace while computing the block

    @property
    def flops_bwd(self) -> float:
        return 2.0 * self.flops_fwd  # standard dL/dx + dL/dw cost

    @property
    def flops_recompute(self) -> float:
        return self.flops_fwd


def trace_superblock(cfg, batch: int, seq: int) -> TraceProfile:
    """The op-level profile of one superblock forward at (batch, seq)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    defs = M.param_defs(cfg)["blocks"]
    with FakeTensorMode():
        one = L.map_defs(lambda d: torch.empty(d.shape[1:], dtype=L.torch_dtype(d.dtype)), defs)
        x = torch.empty(batch, seq, cfg.d_model, dtype=L.torch_dtype(cfg.dtype))
        return profile_fn(lambda p, x: M.apply_superblock(p, x, cfg)[0], one, x,
                          weight_args=(0,))


def profile_superblock(cfg, batch: int, seq: int) -> BlockProfile:
    """Profile one superblock forward at (batch, seq)."""
    from repro_torch.models.layers import torch_dtype

    prof = trace_superblock(cfg, batch, seq)
    itemsize = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    return BlockProfile(
        flops_fwd=prof.total_flops,
        hbm_bytes_fwd=prof.total_bytes,
        act_residual_bytes=prof.residual_act_bytes,
        boundary_bytes=math.prod((batch, seq, cfg.d_model)) * itemsize,
        peak_transient_bytes=prof.peak_live_bytes,
    )
