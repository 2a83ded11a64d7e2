"""Mixed-precision Adam with fp32 master weights.

Port of ``src/repro/optim/adam.py``. The state mirrors the parameter tree:
``{"master", "m", "v"}`` fp32 trees and the step ``count``, an integer kept
on the host. Unlike the JAX package, the update runs **in place** on the
state tensors and the parameters (the caller's tree is the new state).

``AdamConfig.use_fused_kernel`` keeps its meaning: True sends every leaf
through the kernels package's ``fused_adam_update`` -- the CUDA kernel for
parameters on the card, the plain ``ref.fused_adam_ref`` for parameters on
the CPU. Its default here is **True**, the one default that differs from
the JAX package: on the CPU it reaches the plain version, so it costs the
tests nothing. Each leaf's update runs where its gradient lies. The kernel
path also takes parameters and optimizer states that lie in pinned host
memory (a ``host`` chunk's, see ``train/step_builder.py``): its wrapper
streams them through device staging buffers with copy-engine copies and
writes them back in place (``kernels/fused_adam.py``); the plain path (``use_fused_kernel=False``) copies such tensors
to the gradient's device and back, as the JAX package round-trips host
states (``adam.py:61-65, 86-90``). The arithmetic is the same. The per-step
scalars ``[lr, b1, b2, eps, wd, bc1, bc2, 0]`` reach the kernel as one (8,)
fp32 device tensor, and gradient clipping scales the grads with plain torch
ops before the kernel, as JAX does outside the Pallas call. The leaves'
updates run under the profiler annotation ``adam_update``, so a trace shows
the optimizer's span on the device (its copies included) beside its kernels.

On several data ranks the update runs on each rank's shards, element by
element as on one device: a ZeRO-sharded leaf's weights, gradient and
states are this rank's shard (a host chunk's states, and under
``host_params`` its weights, pinned shards through the same pipeline).
Under ``zero1_persistent`` a persistent leaf's states are shards while its
weights are replicated: ``train/sync.XlaSync.update_views`` hands the
update this rank's slice of the weights and of the gradient, and
all-gathers the new bf16 slices into the weights after it. Over the
model axis a leaf's weights, gradient and states are this rank's 2-D
shard, and ``grad_norm`` (``train/sync.grad_norm``) counts every leaf once
across the mesh, so the clip scales every shard alike.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import kernels as K
from repro_torch.compat import pinned_empty


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    use_fused_kernel: bool = True


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree`` order: dict keys sorted, lists in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [x for v in tree for x in tree_leaves(v)]


def tree_map(fn, tree, *rest):
    """Map over the leaves of ``tree`` (and the same leaves of ``rest``),
    visiting them in ``tree_leaves`` order."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]


def init_opt_state(params) -> dict:
    """master: fp32 copy; m, v: fp32 zeros; same tree and device as params
    (placing a chunk's states in host memory is ``build_train_step``'s part)."""
    master = tree_map(lambda p: p.detach().float().clone(), params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {"master": master, "m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": 0}


def sum_sq(g: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of squares of one leaf. A leaf widened to fp32 is
    squared in place: one fp32 copy of it at a time, not two."""
    if g.dtype == torch.float32:
        return torch.sum(torch.square(g))
    return torch.sum(g.float().square_())


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, on the leaves'
    device, the leaves' sums added in ``tree_leaves`` order."""
    return torch.sqrt(sum(sum_sq(g) for g in tree_leaves(tree)))


# elements a bf16 gradient is clipped in at a time (a 256 MB fp32 copy)
CLIP_PIECE = 1 << 26


def clip_by_global_norm(grads, max_norm: float, norm: torch.Tensor | None = None):
    """Scale the grads by min(1, max_norm / norm) in fp32, back to each
    leaf's dtype, **in place** and, for a contiguous bf16 leaf, in pieces of
    ``CLIP_PIECE`` elements: the product is elementwise, so the values are
    those of the whole leaf at once, without a second gradient tree or an
    fp32 copy of a stacked leaf on the device. Returns (grads, norm)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)

    def clip(g):
        if g.dtype == torch.float32:
            return g.mul_(scale)
        pieces = g.view(-1).split(CLIP_PIECE) if g.is_contiguous() else (g,)
        for piece in pieces:
            piece.copy_(piece.float() * scale)
        return g

    return tree_map(clip, grads), norm


def bias_corrections(cfg: AdamConfig, count: int) -> tuple[float, float]:
    """(1 - b1 ** count, 1 - b2 ** count), computed in fp32 as JAX does."""
    c = torch.tensor(float(count), dtype=torch.float32)
    return tuple(float(1 - torch.tensor(b, dtype=torch.float32) ** c) for b in (cfg.b1, cfg.b2))


def adam_scalars(cfg: AdamConfig, lr, count: int, device) -> torch.Tensor:
    """The (8,) fp32 scalars of step ``count`` (1-based) on ``device``:
    ``[lr, b1, b2, eps, wd, bc1, bc2, 0]``."""
    bc1, bc2 = bias_corrections(cfg, count)
    host = torch.tensor([float(lr), cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay, bc1, bc2, 0.0],
                        dtype=torch.float32)
    if torch.device(device).type == "cuda":
        host = pinned_empty(host.shape, host.dtype).copy_(host)
    return host.to(device, non_blocking=True)


def _plain_update(p, g, master, m, v, cfg: AdamConfig, lr, bc1, bc2) -> None:
    """The jnp path of ``_update_leaf``, in place; p and states that lie
    elsewhere than g (pinned host) are copied to g's device and back."""
    dev = g.device
    ma, mm, vv = (t.to(dev, non_blocking=True) for t in (master, m, v))
    gf = g.float()
    m_new = cfg.b1 * mm + (1 - cfg.b1) * gf
    v_new = cfg.b2 * vv + (1 - cfg.b2) * gf * gf
    upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
    if cfg.weight_decay:
        upd = upd + cfg.weight_decay * ma
    master_new = ma - lr * upd
    for dst, src in ((p, master_new.to(p.dtype)), (master, master_new), (m, m_new),
                     (v, v_new)):
        dst.copy_(src, non_blocking=True)


@torch.no_grad()
def adam_update(params, grads, opt_state: dict, cfg: AdamConfig, lr,
                grad_norm: torch.Tensor | None = None) -> torch.Tensor:
    """One step, in place on ``params`` and ``opt_state``; returns the
    global gradient norm (before clipping), a device scalar."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, norm=grad_norm)
    opt_state["count"] += 1
    count = opt_state["count"]
    flat_p = tree_leaves(params)
    flat = [tree_leaves(t) for t in (grads, opt_state["master"], opt_state["m"], opt_state["v"])]
    with torch.profiler.record_function("adam_update"):  # the leaves' updates, copies included
        if cfg.use_fused_kernel:
            scalars = {}
            for p, g, ma, m, v in zip(flat_p, *flat):
                if g.device not in scalars:
                    scalars[g.device] = adam_scalars(cfg, lr, count, g.device)
                # a tied embedding's gradient sums a row-major and a transposed
                # product, and comes out strided: the kernel takes dense rows
                K.fused_adam_update(p, g.contiguous(), ma, m, v, scalars[g.device])
        else:
            bc1, bc2 = bias_corrections(cfg, count)
            for p, g, ma, m, v in zip(flat_p, *flat):
                _plain_update(p, g, ma, m, v, cfg, lr, bc1, bc2)
    return gnorm


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warmup from 0 (the rate at step 0 is 0), then cosine to 0."""
    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return 0.5 * base_lr * (1 + math.cos(math.pi * prog))

    return lr
