"""Mamba-2 (SSD -- state-space duality) mixer [arXiv:2405.21060].

Port of ``src/repro/models/mamba2.py``: the chunked SSD, quadratic within
chunks of length Q and a linear recurrence across them, and the single-step
recurrence decode runs (S = 1 with a carried state). Plain functions on
tensors, like ``models/moe.py``; the reference has no Pallas kernel here, so
the SSD's products are plain PyTorch, and the gated RMSNorm is ``L.rmsnorm``
(the RMSNorm kernel on CUDA tensors).

The reference's einsums are written out as the pairwise products its
``jnp.einsum`` emits (seven ``dot_general``s a block), in the same order:
the contractions as ``torch.matmul`` in fp32 (no TF32: the port sets no
such flag), and the three products with no contracted axis through
``L.broadcast_dot``, which the profiler counts as the reference counts
those dots. The ``lax.scan`` over chunks is a Python loop. The depthwise
conv stays the reference's sum of K shifted products, so its bf16 rounding
follows the reference's order. Every shape is static, so the step traces
on fake tensors and is captured in the serving step's CUDA graph.

Autograd keeps no more than the reference's residuals: the chunk loop's
backward is written out (``_ChunkScan``, which keeps each carry once), the
product with the permuted x keeps x itself (``_Matmul``), C is not
broadcast over the heads, and the skip term keeps x in bf16.

Over the model axis (``tp``) a rank runs its share of the SSD heads
(``rank_params``, ``apply_mamba2``), in training and in decode: the
reference lets GSPMD split the flat ``tp`` dims of ``in_proj`` and the
conv, whose segments a flat shard cuts across, so those leaves are taken
whole at use and read by head. Where the extent does not divide the heads
the mixer runs replicated on every rank (``whole_params``).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import NONE, TP, ZERO, ParamDef


def mamba2_dims(cfg):
    mc = cfg.mamba2
    d_in = mc.expand * cfg.d_model
    n_heads = d_in // mc.head_dim
    conv_dim = d_in + 2 * mc.d_state
    return d_in, n_heads, conv_dim


def mamba2_defs(cfg) -> dict:
    mc = cfg.mamba2
    d = cfg.d_model
    d_in, n_heads, conv_dim = mamba2_dims(cfg)
    proj_out = 2 * d_in + 2 * mc.d_state + n_heads  # [z, x, B, C, dt]
    return {
        "in_proj": ParamDef((d, proj_out), (ZERO, TP)),
        "conv_w": ParamDef((mc.d_conv, conv_dim), (NONE, TP), scale=0.1),
        "conv_b": ParamDef((conv_dim,), (TP,), init="zeros"),
        "A_log": ParamDef((n_heads,), (TP,), init="ones", dtype="float32"),
        "D": ParamDef((n_heads,), (TP,), init="ones", dtype="float32"),
        "dt_bias": ParamDef((n_heads,), (TP,), init="zeros", dtype="float32"),
        "norm_scale": ParamDef((d_in,), (TP,), init="ones"),
        "out_proj": ParamDef((d_in, d), (TP, ZERO)),
    }


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x times its sigmoid, each rounded to x's dtype."""
    return x * torch.sigmoid(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """Depthwise causal conv. x: (B, S, C); w: (K, C). Returns (y, new_state):
    the silu of the K shifted products summed, plus the bias; the last K - 1
    inputs (a view of the padded input)."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    new_state = xp[:, -(k - 1):] if k > 1 else state
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return _silu(y + b), new_state


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) -> (..., Q, Q) with out[i, j] = sum(a[j+1..i]), -inf above
    the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, seg, -torch.inf)


class _ChunkScan(torch.autograd.Function):
    """The ``lax.scan`` over chunks as a loop, ``carry = carry * decay[c] +
    states[c]``, with its backward written out: the reverse recurrence
    reads the states entering each chunk, which are this function's own
    output, so the carries are kept once (autograd through the loop would
    keep each carry again beside the stacked output)."""

    @staticmethod
    def forward(ctx, states, decay, carry):
        entering = []
        for st, dec in zip(states.unbind(1), decay.unbind(1)):
            entering.append(carry)
            carry = carry * dec[:, :, None, None] + st
        entering = torch.stack(entering, dim=1)
        ctx.save_for_backward(entering, decay)
        return entering, carry

    @staticmethod
    def backward(ctx, g_entering, g_final):
        entering, decay = ctx.saved_tensors
        g = torch.zeros_like(entering[:, 0]) if g_final is None else g_final
        g_states, g_decay = [], []
        for c in range(entering.shape[1] - 1, -1, -1):
            g_states.append(g)
            g_decay.append((g * entering[:, c]).sum((-2, -1)))
            g = g * decay[:, c, :, None, None]
            if g_entering is not None:
                g = g + g_entering[:, c]
        return torch.stack(g_states[::-1], dim=1), torch.stack(g_decay[::-1], dim=1), g


def chunk_scan(states: torch.Tensor, decay: torch.Tensor, carry: torch.Tensor):
    """The inter-chunk recurrence. states: (B, nc, H, P, N); decay: (B, nc,
    H); carry: (B, H, P, N) fp32. Returns (the state entering each chunk,
    (B, nc, H, P, N); the final state)."""
    with torch.profiler.record_function("ssd_chunk_scan"):  # a span for the step's profile
        return _ChunkScan.apply(states, decay, carry)


class _Matmul(torch.autograd.Function):
    """``torch.matmul`` that keeps its operands as given for the backward.
    For a strided operand (a permuted view) autograd through ``matmul``
    keeps the contiguous copy the batched product makes, beside the
    operand's own tensor that another product keeps; here the copy is made
    again in the backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return (torch.matmul(g, b.transpose(-1, -2)).sum_to_size(a.shape),
                torch.matmul(a.transpose(-1, -2), g).sum_to_size(b.shape))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
                c_mat: torch.Tensor, chunk_size: int, initial_state=None):
    """x: (B, S, H, P); dt: (B, S, H) positive step sizes; a: (H,) negative
    decay rates; b_mat, c_mat: (B, S, N). Returns (y (B, S, H, P) in x's
    dtype, final_state (B, H, P, N) fp32). S is padded to a multiple of the
    chunk and the padding sliced off."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk_size, s)
    xdt = (x * dt[..., None]).float()  # dt-scaled input
    adt = (a[None, None, :] * dt).float()  # (B, S, H) log-decay per step
    if s % q:  # padded after the products, which then keep x itself
        pad = q - s % q
        xdt = torch.nn.functional.pad(xdt, (0, 0, 0, 0, 0, pad))
        adt = torch.nn.functional.pad(adt, (0, 0, 0, pad))
        b_mat = torch.nn.functional.pad(b_mat, (0, 0, 0, pad))
        c_mat = torch.nn.functional.pad(c_mat, (0, 0, 0, pad))
    sp = xdt.shape[1]
    nc = sp // q

    xc = xdt.reshape(bsz, nc, q, h, p)
    ac = adt.reshape(bsz, nc, q, h)
    bc = b_mat.reshape(bsz, nc, q, n).float()
    cc = c_mat.reshape(bsz, nc, q, n).float()

    a_cs = torch.cumsum(ac, dim=2)  # (B, nc, Q, H)
    # 1) intra-chunk, quadratic within a chunk: (C B^T) * L, then times x
    l_mat = torch.exp(_segsum(ac.movedim(-1, 2)))  # (B, nc, H, Q, Q)
    g = torch.matmul(cc, bc.transpose(-1, -2))  # (B, nc, Q_i, Q_j)
    m = L.broadcast_dot(l_mat, g[:, :, None])  # (B, nc, H, Q_i, Q_j)
    y_diag = _Matmul.apply(m, xc.permute(0, 1, 3, 2, 4))  # (B, nc, H, Q, P)
    # 2) per-chunk end states: (decay x)^T B
    decay_states = torch.exp(a_cs[:, :, -1:, :] - a_cs)  # (B, nc, Q, H)
    wx = L.broadcast_dot(decay_states[..., None], xc)  # (B, nc, Q, H, P)
    states = torch.matmul(wx.reshape(bsz, nc, q, h * p).transpose(-1, -2), bc)
    states = states.reshape(bsz, nc, h, p, n)
    # 3) inter-chunk recurrence, the state entering each chunk
    chunk_decay = torch.exp(a_cs[:, :, -1, :])  # (B, nc, H)
    carry = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prev_states, carry = chunk_scan(states, chunk_decay, carry)
    # 4) state -> output within a chunk. The reference's einsum takes the
    # pair of fewer FLOPs first (opt_einsum's path): decay times C when
    # N < P, else C times the states; the latter as one product of C with
    # every head's states, (B, nc, Q, N) x (B, nc, N, H P), so that C is
    # not broadcast over the heads
    a_exp = torch.exp(a_cs)  # (B, nc, Q, H)
    if n < p:
        dc = L.broadcast_dot(a_exp.movedim(-1, 2)[..., None], cc[:, :, None])  # (B, nc, H, Q, N)
        y_off = torch.matmul(dc, prev_states.transpose(-1, -2)).movedim(2, 3)  # (B, nc, Q, H, P)
    else:
        cp = torch.matmul(cc, prev_states.reshape(bsz, nc, h * p, n).transpose(-1, -2))
        y_off = L.broadcast_dot(a_exp[..., None], cp.reshape(bsz, nc, q, h, p))
    y = (y_diag.movedim(2, 3) + y_off).reshape(bsz, sp, h, p)[:, :s]
    return y.to(x.dtype), carry


def rank_heads(cfg, tp) -> tuple[int, int] | None:
    """(this rank's first SSD head, its heads) over ``tp.size`` model ranks;
    None where the extent does not divide the heads: the mixer then runs
    replicated (``whole_params``)."""
    _, n_heads, _ = mamba2_dims(cfg)
    if n_heads % tp.size:
        return None
    hl = n_heads // tp.size
    return tp.rank * hl, hl


# each leaf's tp-tagged dim (mamba2_defs) and its full length
def _tp_dims(cfg) -> dict[str, tuple[int, int]]:
    mc = cfg.mamba2
    d_in, n_heads, conv_dim = mamba2_dims(cfg)
    return {"in_proj": (-1, 2 * d_in + 2 * mc.d_state + n_heads), "conv_w": (-1, conv_dim),
            "conv_b": (0, conv_dim), "A_log": (0, n_heads), "D": (0, n_heads),
            "dt_bias": (0, n_heads), "norm_scale": (0, d_in), "out_proj": (0, d_in)}


def whole_params(params: dict, cfg, tp) -> dict:
    """Every weight of the mixer whole (``TensorParallel.replicated``), for
    a rank that computes all the SSD heads: where the model extent does not
    divide them, the mixer runs replicated, as the reference's partitioned
    program computes the same function."""
    return {name: tp.replicated(params[name], dim, full)
            for name, (dim, full) in _tp_dims(cfg).items()}


def rank_params(params: dict, cfg, tp) -> dict:
    """The weights of this rank's SSD heads. ``in_proj``'s columns are
    ``[z | x | B | C | dt]`` and the conv's ``[x | B | C]``, each split over
    the model axis as one flat dim (``_fits``), so a shard does not hold
    whole heads: they are taken whole (``whole_weight``: all-gathered,
    reduce-scatter backward) and the rank reads its heads' ``z``, ``x`` and
    ``dt`` columns and all of ``B`` and ``C``, which every head reads (one
    group). ``A_log``, ``D``, ``dt_bias`` and ``out_proj``'s rows split by
    whole heads (``own_part``); ``norm_scale`` is taken whole, for the
    gated norm's whole rows."""
    mc = cfg.mamba2
    d_in, n_heads, conv_dim = mamba2_dims(cfg)
    h0, hl = rank_heads(cfg, tp)
    p, n = mc.head_dim, mc.d_state
    cols = slice(h0 * p, (h0 + hl) * p)  # the heads' channels within a d_in segment
    w = tp.whole_weight(params["in_proj"], -1, 2 * d_in + 2 * n + n_heads)
    dt0 = 2 * d_in + 2 * n + h0
    in_proj = torch.cat([w[:, cols], w[:, d_in:2 * d_in][:, cols],
                         w[:, 2 * d_in:2 * d_in + 2 * n], w[:, dt0:dt0 + hl]], dim=-1)

    def conv(t):  # [x | B | C]: the heads' x channels, all of B and C
        t = tp.whole_weight(t, -1, conv_dim)
        return torch.cat([t[..., cols], t[..., d_in:]], dim=-1)

    out = {name: tp.own_part(params[name], 0, n_heads, h0, hl)
           for name in ("A_log", "D", "dt_bias")}
    return {**out, "in_proj": in_proj, "conv_w": conv(params["conv_w"]),
            "conv_b": conv(params["conv_b"]),
            "norm_scale": tp.whole_weight(params["norm_scale"], 0, d_in),
            "out_proj": tp.own_part(params["out_proj"], 0, d_in, h0 * p, hl * p)}


def apply_mamba2(params: dict, x: torch.Tensor, cfg, *, state=None, return_state: bool = False,
                 tp=None):
    """x: (B, S, D) -> (B, S, D). ``state`` = (conv_state, ssm_state) for
    decode; with ``return_state`` also returns the new pair.

    ``tp`` (``dist.tensor_parallel.TensorParallel``): this rank runs its
    ``n_heads / size`` SSD heads (``rank_params``): the input projection
    column-parallel, the conv on its channels, the SSD on its heads; the
    gated norm's mean spans all of ``d_in``, so the gated rows are
    all-gathered over the model group (reduce-scatter backward) and the
    kernel normalises whole rows, of which the rank keeps its heads'
    columns; ``out_proj`` is row-parallel, the partial outputs reduced
    (scattered over the sequence under sequence parallelism). A decode
    ``state`` is then the rank's: the conv's state over its heads' x
    channels and all of B and C, the SSM state of its heads
    (``mamba2_state_defs``). Where the extent does not divide the heads
    the mixer runs replicated (``whole_params``), its state whole."""
    mc = cfg.mamba2
    d_in, n_heads, _ = mamba2_dims(cfg)
    heads = None if tp is None else rank_heads(cfg, tp)
    if tp is not None:
        if heads is None:
            params = whole_params(params, cfg, tp)
        else:
            h0, n_heads = heads
            params = rank_params(params, cfg, tp)
            d_in = n_heads * mc.head_dim
        x = tp.enter(x, heads is not None)
    b, s, _ = x.shape
    proj = x @ params["in_proj"]
    z, xin, bmat, cmat, dt = torch.split(proj, [d_in, d_in, mc.d_state, mc.d_state, n_heads],
                                         dim=-1)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    conv_state = state[0] if state is not None else None
    conv_out, new_conv_state = _causal_conv(conv_in, params["conv_w"], params["conv_b"],
                                            conv_state)
    xin, bmat, cmat = torch.split(conv_out, [d_in, mc.d_state, mc.d_state], dim=-1)
    xh = xin.reshape(b, s, n_heads, mc.head_dim)
    dtp = _softplus(dt.float() + params["dt_bias"])  # (B, S, H)
    a = -torch.exp(params["A_log"])  # (H,)
    ssm_state = state[1] if state is not None else None
    y, new_ssm_state = ssd_chunked(xh, dtp, a, bmat, cmat, mc.chunk_size, ssm_state)
    # y + x D with x widened, x kept in bf16 for the backward (as a widened
    # copy it would be kept again in fp32)
    y = torch.addcmul(y, xh, params["D"][None, None, :, None])
    y = y.reshape(b, s, d_in).to(x.dtype)
    if heads is None:
        y = L.rmsnorm(y * _silu(z), params["norm_scale"])
    else:  # whole rows of d_in for the norm, then this rank's columns
        y = L.rmsnorm(tp.gather_partial(y * _silu(z), -1), params["norm_scale"])
        y = y[..., h0 * mc.head_dim:h0 * mc.head_dim + d_in]
    out = y @ params["out_proj"]
    if tp is not None:
        out = tp.exit(out, heads is not None)
    if return_state:
        return out, (new_conv_state, new_ssm_state)
    return out


def mamba2_state_defs(cfg, batch: int, tp=None):
    """(shape, dtype) of the decode state: conv (B, K - 1, conv_dim) in the
    model's dtype, ssm (B, H, P, N) in fp32; ``tp``: a rank's, over its
    heads' x channels and all of B and C, and its H heads (the whole state
    where the mixer runs replicated)."""
    mc = cfg.mamba2
    _, n_heads, conv_dim = mamba2_dims(cfg)
    heads = None if tp is None else rank_heads(cfg, tp)
    if heads is not None:
        n_heads = heads[1]
        conv_dim = n_heads * mc.head_dim + 2 * mc.d_state
    return (((batch, mc.d_conv - 1, conv_dim), L.torch_dtype(cfg.dtype)),
            ((batch, n_heads, mc.head_dim, mc.d_state), torch.float32))
