"""Mixture-of-Experts layer: top-k token-choice routing with capacity-based
dispatch (Shazeer-style).

Port of ``src/repro/models/moe.py``. Dispatch and combine stay the
reference's dense ``(T, E, C)`` einsums:

* the values are the reference's: dispatching bf16 data through a 0/1 fp32
  tensor is exact, and the combine sums at most ``top_k`` products a row;
* the matmul FLOPs are the reference's, which the planner's parity rests on
  (``core/profiler.py``);
* every shape is static, so the step traces on fake tensors and is captured
  in a CUDA graph (``serve/prefill.ServeStep``): no ``nonzero``, boolean
  indexing or host read, and one-hots are comparisons with an ``arange``.

The fp32 einsums run in plain fp32 (the port sets no TF32 flag): TF32
would round ``x`` inside the dispatch and change its values. Every expert
runs on its ``C`` capacity rows whether or not tokens reached them, so a
decode step reads every expert's weights; an index-based dispatch is open
work (ROADMAP.md).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import NONE, TP, ZERO, ParamDef, apply_mlp

EXP = "exp"  # expert axis tag (expert parallelism in the JAX package)


def moe_defs(cfg) -> dict:
    mc = cfg.moe
    d = cfg.d_model
    de = mc.d_expert or cfg.d_ff
    gated = cfg.mlp in ("swiglu", "geglu")
    defs = {
        "router": ParamDef((d, mc.num_experts), (ZERO, NONE), scale=0.02, dtype="float32"),
        "w1": ParamDef((mc.num_experts, d, de), (EXP, ZERO, NONE)),
        "w2": ParamDef((mc.num_experts, de, d), (EXP, NONE, ZERO)),
    }
    if gated:
        defs["w3"] = ParamDef((mc.num_experts, d, de), (EXP, ZERO, NONE))
    if mc.num_shared_experts:
        ds = de * mc.num_shared_experts
        defs["shared_w1"] = ParamDef((d, ds), (ZERO, TP))
        defs["shared_w2"] = ParamDef((ds, d), (TP, ZERO))
        if gated:
            defs["shared_w3"] = ParamDef((d, ds), (ZERO, TP))
    return defs


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of an integer tensor over ``n`` classes, by comparison
    with an ``arange`` (no check of the indices on the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _top_k_gating(logits: torch.Tensor, top_k: int, route=None):
    """logits: (T, E) fp32 -> (weights (T, k), indices (T, k), one_hot
    (T, k, E), aux_loss). ``lax.top_k`` orders equal values lower index
    first: a stable descending sort, sliced, does the same. ``route``: the
    means run over the batch group's tokens."""
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, indices = top.values[:, :top_k], top.indices[:, :top_k]
    weights = weights / weights.sum(dim=-1, keepdim=True)
    # load-balance auxiliary loss (Switch-style): E * sum_e f_e * p_e
    num_experts = logits.shape[-1]
    one_hot = _one_hot(indices, num_experts)  # (T, k, E)
    if route is None:
        tokens_per_expert = one_hot.sum(dim=1).mean(dim=0)  # fraction (E,)
        mean_probs = probs.mean(dim=0)
    else:
        n = logits.shape[0] * route.size
        tokens_per_expert = route.total(one_hot.sum(dim=(0, 1))) / n
        mean_probs = route.total(probs.sum(dim=0)) / n
    aux = num_experts * (tokens_per_expert * mean_probs).sum()
    return weights, indices, one_hot, aux


def expert_capacity(cfg, tokens: int) -> int:
    """Rows each expert processes: ``ceil(top_k * T * cf / E)``, at least 1."""
    mc = cfg.moe
    return max(math.ceil(mc.top_k * tokens * mc.capacity_factor / mc.num_experts), 1)


def apply_moe(params: dict, x: torch.Tensor, cfg, tp=None,
              route=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux loss, an fp32 scalar).

    Each expert takes at most C (``expert_capacity``) of the (token, k)
    choices, counted in token-major, then-k order; the overflow is dropped
    (the token keeps its residual stream only).

    ``route`` (``dist.tensor_parallel.BatchGroup``): the xla path's ranks
    that hold other rows of the batch route them as the reference's one
    program routes the global batch: the capacity from the group's token
    count, each choice's position offset by the lower ranks' counts (rank
    r holds the r-th slice of the microbatch's tokens), ``f_e`` and ``p_e``
    the group's means. The manual kinds pass none: the reference runs
    their step under ``shard_map``, where each device routes its own rows.

    ``tp`` (``dist.tensor_parallel.TensorParallel``): the router and the
    gating run on every rank over every token, as on one device, and are
    differentiated so on every rank (the slice of ``combine`` a rank uses
    gathers its gradient back whole: the router's gradient and the aux
    loss are counted once). Where the experts split over the model axis a
    rank dispatches to and runs its ``E / size`` experts, through its
    slice of ``dispatch`` and ``combine``, combines their outputs in fp32
    and reduces them over the model group in fp32 before the cast. The
    shared expert is ``apply_mlp``'s column / row split."""
    mc = cfg.moe
    xr = x if tp is None else tp.enter(x, partial=False)
    b, s, d = xr.shape
    t, k, e = b * s, mc.top_k, mc.num_experts
    xt = xr.reshape(t, d)
    logits = xt.float() @ params["router"]
    weights, _, one_hot, aux = _top_k_gating(logits, k, route)

    capacity = expert_capacity(cfg, t if route is None else t * route.size)
    # position of each (token, k) choice within its expert's buffer
    cum = torch.cumsum(one_hot.reshape(t * k, e), dim=0)
    if route is not None:
        cum = cum + route.count_before(one_hot.sum(dim=(0, 1)))
    pos_in_expert = (cum - 1).reshape(t, k, e)
    within_cap = (pos_in_expert < capacity) & (one_hot > 0)
    pos_clipped = pos_in_expert.clamp(0, capacity - 1).to(torch.int32)
    cap_one_hot = _one_hot(pos_clipped, capacity)  # (T, k, E, C)
    dispatch = torch.einsum("tke,tkec->tec", within_cap.float(), cap_one_hot)
    combine = torch.einsum("tke,tkec->tec",
                           torch.where(within_cap, weights[..., None].float(), 0.0), cap_one_hot)
    split = tp is not None and params["w1"].shape[0] != e
    if split:  # this rank's experts
        el = params["w1"].shape[0]
        dispatch = dispatch[:, tp.rank * el:(tp.rank + 1) * el]
        combine = tp.split(combine, 1)
        xt = tp.copy(xt)
    expert_in = torch.einsum("tec,td->ecd", dispatch, xt.float()).to(x.dtype)
    h = torch.einsum("ecd,edf->ecf", expert_in, params["w1"])
    if "w3" in params:
        gate = torch.einsum("ecd,edf->ecf", expert_in, params["w3"])
        act = F.silu(h) if cfg.mlp == "swiglu" else F.gelu(h, approximate="tanh")
        h = act * gate
    elif cfg.mlp == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif cfg.mlp == "relu2":
        h = torch.square(F.relu(h))
    expert_out = torch.einsum("ecf,efd->ecd", h, params["w2"])
    out = torch.einsum("tec,ecd->td", combine, expert_out.float())
    if tp is not None:
        out = tp.exit(out.reshape(b, s, d), partial=split)
    out = out.to(x.dtype).reshape(-1, d)

    if mc.num_shared_experts:
        shared = {n[len("shared_"):]: w for n, w in params.items() if n.startswith("shared_")}
        kind = cfg.mlp if "shared_w3" in params else "gelu"
        ds = (mc.d_expert or cfg.d_ff) * mc.num_shared_experts
        out = out + apply_mlp(shared, x.reshape(-1, d) if tp is None else x, kind, tp,
                              ds).reshape(-1, d)
    return out.reshape(x.shape), aux * mc.aux_loss_weight
