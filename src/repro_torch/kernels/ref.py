"""Plain PyTorch versions of the ported kernels.

Op for op the oracles of ``src/repro/kernels/ref.py`` (``rmsnorm_ref``,
``paged_attention_ref``, ``flash_attention_ref``, ``fused_adam_ref``,
``fused_quantize_ef_ref``), plus
the plain versions of what the training kernels compute beyond them:
``attention_lse_ref`` (the forward with its log-sum-exp),
``flash_attention_bwd_ref`` (``models/layers.py::_mea_bwd`` over the whole
row) and ``rmsnorm_bwd_ref``; and two models of a kernel's own arithmetic,
which only the tests run: ``paged_attention_split_ref`` (the paged kernel's
split-KV) and ``flash_attention_tiled_ref`` (the flash forward's key tiles
and online softmax). The CPU path of the
kernels package runs these, and the tests and ``chip_smoke.py`` hold the
CUDA kernels against them.
"""
from __future__ import annotations

import math

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * scale


def paged_attention_ref(q, k_hot, v_hot, k_cold, v_cold, sel, mask):
    """Materialise the ring view (cache row ``r`` lives at ring row
    ``r % hot_window``), select the canonical rows, then run
    ``_masked_decode_attn``'s op sequence.

    q: (B, 1, Hq, hd); k/v_hot: (B, W, Hkv, hd); k/v_cold: (B, S, Hkv, hd),
    on q's device or in host memory; sel: (B, S) bool (True -> ring
    canonical); mask: (B, S) fp32 additive.
    """
    b, _, hq, hd = q.shape
    s_kv, hkv = k_cold.shape[1], k_cold.shape[2]
    w = k_hot.shape[1]
    g = hq // hkv
    dev = q.device
    rows = torch.arange(s_kv, device=dev) % w
    s = sel.to(dev)[..., None, None]
    # stream-ordered copies: a pinned cold store is read without a host sync
    k = torch.where(s, k_hot[:, rows], k_cold.to(dev, non_blocking=True))
    v = torch.where(s, v_hot[:, rows], v_cold.to(dev, non_blocking=True))
    qh = (q.float() / math.sqrt(hd)).reshape(b, hkv, g, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qh, k.float())
    logits = logits + mask.to(dev)[:, None, None, :]
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def paged_attention_split_ref(q, k_hot, v_hot, k_cold, v_cold, sel, mask, rows_per_split: int):
    """The CUDA kernel's split-KV arithmetic in plain PyTorch, for the tests:
    the same function as ``paged_attention_ref``, computed per split of
    ``rows_per_split`` cache rows as an online-softmax partial (m, l, acc)
    and merged in split order.

    Rows masked at -1e30 weigh exactly 0 when the batch row has any
    attendable row (a whole-row flag, not a per-split one); a split with no
    attendable row has m = -inf and weighs 0 in the merge. A batch row with
    every entry masked keeps the mask in its logits, so every row weighs
    the same, as in the reference.
    """
    b, _, hq, hd = q.shape
    s_kv, hkv = k_cold.shape[1], k_cold.shape[2]
    w = k_hot.shape[1]
    g = hq // hkv
    dev = q.device
    rows = torch.arange(s_kv, device=dev) % w
    s = sel.to(dev)[..., None, None]
    k = torch.where(s, k_hot[:, rows], k_cold.to(dev)).float()
    v = torch.where(s, v_hot[:, rows], v_cold.to(dev)).float()
    qh = (q.float() / math.sqrt(hd)).reshape(b, hkv, g, hd)
    mask = mask.to(dev)
    live = mask > -1e30
    skip = live.any(dim=1, keepdim=True)
    logits = torch.einsum("bkgd,bskd->bkgs", qh, k) + mask[:, None, None, :]
    logits = torch.where((live | ~skip)[:, None, None, :], logits, float("-inf"))
    ms, ls, accs = [], [], []
    for s0 in range(0, s_kv, rows_per_split):
        part = logits[..., s0:s0 + rows_per_split]
        m = part.amax(dim=-1, keepdim=True)  # -inf for a split with no attended row
        p = torch.where(part == float("-inf"), 0.0, torch.exp(part - m))
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p, v[:, s0:s0 + rows_per_split]))
    m_all = torch.stack(ms).amax(dim=0)
    num, den = torch.zeros_like(accs[0]), torch.zeros_like(ls[0])
    for m, l, acc in zip(ms, ls, accs):
        c = torch.where(m == float("-inf"), 0.0, torch.exp(m - m_all))
        num = num + c * acc
        den = den + c * l
    return (num / den).reshape(b, 1, hq, hd).to(q.dtype)


def _mask(sq: int, sk: int, causal: bool, window: int, q_offset: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: True where query row i (at position i + q_offset) attends key j."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Hq, Sq, hd); k, v: (B, Hkv, Sk, hd). fp32 softmax, output in q's dtype."""
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    qh = q.reshape(b, hkv, g, sq, hd).float() / math.sqrt(hd)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qh, k.float())
    mask = _mask(sq, sk, causal, window, 0, q.device)
    logits = torch.where(mask, logits, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.reshape(b, hq, sq, hd).to(q.dtype)


def unattended_rows(sq: int, sk: int, causal: bool, window: int,
                    q_offset: int) -> list[tuple[int, int]]:
    """Query rows that attend no key, from the shape alone: at most two
    ``(start, stop)`` ranges (a causal prefix at positions below 0, a
    windowed suffix past the last key's window). Row i, at position
    ``i + q_offset``, attends key j < sk where ``j <= pos`` (causal) and
    ``j > pos - window`` (window)."""
    if sk <= 0:
        return [(0, sq)] if sq else []
    head = min(sq, max(0, -q_offset)) if causal else 0
    tail = min(sq, max(0, sk + window - 1 - q_offset)) if window else sq
    if head >= tail:
        return [(0, sq)] if sq else []
    return [(a, b) for a, b in ((0, head), (tail, sq)) if b > a]


def padded_keys(sk: int, block_kv: int | None) -> int:
    """The key length the JAX references' softmax covers: ``sk`` padded to a
    multiple of ``block_kv`` with zero keys. ``None`` is the Pallas
    kernel's default tile, ``min(128, sk)``; ``_mea`` pads to its own
    ``block_kv``."""
    block = block_kv or min(128, sk)
    return max(1, -(-sk // block) * block) if block else 1


def fix_unattended_fwd(v, out, lse, rows: list[tuple[int, int]], n_keys: int) -> None:
    """Give rows with nothing attended the JAX references' values, in place.

    Those references mask with a finite -1e30, so such a row's logits are
    all -1e30, its running max stays -1e30 and every key of the padded
    range weighs exp(0) = 1: out is the sum of V over the real keys (the
    padded ones are zeros) over ``n_keys``, and lse = -1e30 + log(n_keys),
    which is -1e30 in fp32. v: (B, Sk, Hkv, hd); out (B, Sq, Hq, hd); lse
    (B, Hq, Sq). Does nothing when ``rows`` is empty.
    """
    if not rows:
        return
    g = out.shape[2] // v.shape[2]
    mean = (v.float().sum(dim=1) / n_keys).repeat_interleave(g, dim=1).to(out.dtype)
    lse_val = float(torch.tensor(-1e30, dtype=torch.float32) + math.log(n_keys))
    for a, b in rows:
        out[:, a:b] = mean[:, None]
        lse[:, :, a:b] = lse_val


def fix_unattended_bwd(q, k, v, out, dout, dq, dk, dv, rows: list[tuple[int, int]]) -> None:
    """Add the gradients of rows with nothing attended, in place, as
    ``models/layers.py::_mea_bwd`` computes them: there p = exp(logits -
    lse) = 1 on every key, so with delta = rowsum(dout * out) in fp32 and
    ds = (dout . v_j - delta) * scale rounded to q's dtype, dQ of the row is
    sum_j ds_j k_j, and each key gains ds_j q (dK) and dout (dV). The
    padded keys are zeros and add nothing. Expects dq of those rows 0 and
    dk, dv without their share. Does nothing when ``rows`` is empty."""
    if not rows:
        return
    b, _, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)

    def take(t):
        t = torch.cat([t[:, a:c] for a, c in rows], dim=1)
        return t.reshape(b, t.shape[1], hkv, g, hd).float()

    qu, du, ou = take(q), take(dout), take(out)
    delta = (du * ou).sum(dim=-1)
    dp = torch.einsum("bukgd,bskd->bukgs", du, v.float())
    ds = ((dp - delta[..., None]) * scale).to(q.dtype).float()
    dq_u = torch.einsum("bukgs,bskd->bukgd", ds, k.float()).reshape(b, -1, hq, hd).to(dq.dtype)
    dk.copy_((dk.float() + torch.einsum("bukgs,bukgd->bskd", ds, qu)).to(dk.dtype))
    dv.copy_((dv.float() + du.sum(dim=(1, 3))[:, None]).to(dv.dtype))
    start = 0
    for a, c in rows:
        dq[:, a:c] = dq_u[:, start:start + c - a]
        start += c - a


def _per_kv_head(q, hkv):
    """(kv head, its G query heads) for (B, S, Hq, hd) queries, so the (G,
    Sq, Sk) scores of one group are live at a time."""
    g = q.shape[2] // hkv
    return [(h, q[:, :, h * g:(h + 1) * g]) for h in range(hkv)]


def attention_lse_ref(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
                      block_kv: int | None = None):
    """What the flash forward computes, over the whole row at once.

    q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd). Returns out (B, Sq, Hq, hd)
    in q's dtype and the fp32 log-sum-exp (B, Hq, Sq), with
    ``_mea_forward``'s rounding points: fp32 scores, p rounded to v's dtype
    before P.V with fp32 accumulation, out = acc / max(l, 1e-30),
    lse = m + log(max(l, 1e-30)); masked pairs weigh exactly 0. A row with
    nothing attended gets the JAX references' value (``fix_unattended_fwd``
    over ``padded_keys(sk, block_kv)`` keys).
    """
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    mask = _mask(sq, sk, causal, window, q_offset, q.device)
    outs, lses = [], []
    for h, qg in _per_kv_head(q, hkv):
        s = torch.einsum("bqgd,bsd->bgqs", qg.float(), k[:, :, h].float()) * scale
        s = torch.where(mask, s, torch.tensor(float("-inf"), device=q.device))
        m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        acc = torch.einsum("bgqs,bsd->bqgd", p.to(v.dtype).float(), v[:, :, h].float())
        outs.append(acc / l.permute(0, 2, 1, 3))
        lses.append((m + torch.log(l))[..., 0])
    out = torch.cat(outs, dim=2).to(q.dtype)
    lse = torch.cat(lses, dim=1)
    fix_unattended_fwd(v, out, lse, unattended_rows(sq, sk, causal, window, q_offset),
                       padded_keys(sk, block_kv))
    return out, lse


def _tiles_live(q0: int, nq: int, k0: int, nk: int, sq: int, sk: int, causal: bool,
                window: int, q_offset: int) -> bool:
    """``tiles_live`` of ``csrc/flash_attention.cu``: can any (q, k) of the
    query rows [q0, q0 + nq) and keys [k0, k0 + nk) attend?"""
    if q0 >= sq or k0 >= sk:
        return False
    qmin, qmax = q0 + q_offset, min(q0 + nq, sq) - 1 + q_offset
    if causal and k0 > qmax:
        return False
    return not (window and min(k0 + nk, sk) - 1 <= qmin - window)


def flash_attention_tiled_ref(q, k, v, *, causal: bool = True, window: int = 0,
                              q_offset: int = 0, key_tile: int | None = None,
                              block_kv: int | None = None):
    """The flash forward kernel's arithmetic in plain PyTorch, for the tests:
    the same function as ``attention_lse_ref``, computed as the kernel does.

    Per 64-row query tile, the key tiles of its live range (the contiguous
    range that ``tiles_live`` admits; the others are skipped) in order, with
    an online softmax in the log2 domain: scores times ``scale * log2(e)``,
    masked pairs at -inf, the running max starting at -1e30 (so a row with
    nothing attended yet rescales by exp2(0) = 1), p = exp2(s - m) against
    the running max, rounded to v's dtype before P.V with fp32
    accumulation, the accumulator and row sum rescaled by exp2(m_old -
    m_new). Then out = acc / max(l, 1e-30) and lse = m * ln 2 +
    log(max(l, 1e-30)) in natural log; a row with nothing attended comes
    out of the tiles with out 0 and lse -1e30, and the wrapper's pass over
    such rows (``fix_unattended_fwd``) gives it the JAX references' value.
    Layouts as ``attention_lse_ref``.
    ``key_tile``: 64 or 128 keys a step; None takes the kernel's choice
    (128 when the group Hq / Hkv is even: two heads a block, else 64).
    """
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    k_tile = key_tile or (128 if g % 2 == 0 else 64)
    q_tile = 64
    dev = q.device
    scale_log2 = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32) * torch.tensor(
        math.log2(math.e), dtype=torch.float32)
    mask = _mask(sq, sk, causal, window, q_offset, dev)
    qf = q.float().transpose(1, 2)  # (B, Hq, Sq, hd)
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)  # (B, Hq, Sk, hd)
    vh = v.transpose(1, 2).repeat_interleave(g, dim=1)
    out = torch.empty(b, hq, sq, hd, dtype=torch.float32, device=dev)
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=dev)
    n_kt = -(-sk // k_tile)
    for q0 in range(0, sq, q_tile):
        rows = slice(q0, q0 + q_tile)
        nq = min(q_tile, sq - q0)
        live = [kt for kt in range(n_kt)
                if _tiles_live(q0, q_tile, kt * k_tile, k_tile, sq, sk, causal, window, q_offset)]
        m = torch.full((b, hq, nq), -1e30, device=dev)
        l = torch.zeros(b, hq, nq, device=dev)
        acc = torch.zeros(b, hq, nq, hd, device=dev)
        for kt in range(min(live, default=0), max(live, default=-1) + 1):
            keys = slice(kt * k_tile, (kt + 1) * k_tile)
            s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, rows], kf[:, :, keys]) * scale_log2
            s = torch.where(mask[rows, keys], s, torch.tensor(float("-inf"), device=dev))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(v.dtype).float(), vh[:, :, keys].float())
            m = m_new
        lf = l.clamp_min(1e-30)
        out[:, :, rows] = acc / lf[..., None]
        lse[:, :, rows] = torch.where(m == -1e30, m, m * math.log(2.0)) + torch.log(lf)
    out = out.transpose(1, 2).to(q.dtype)
    fix_unattended_fwd(v, out, lse, unattended_rows(sq, sk, causal, window, q_offset),
                       padded_keys(sk, block_kv))
    return out, lse


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                            q_offset: int = 0):
    """``_mea_bwd``'s arithmetic over the whole row: (dq, dk, dv).

    Layouts as ``attention_lse_ref``; ``lse`` (B, Hq, Sq) fp32. p =
    exp(s - lse) in fp32, rounded to dout's dtype for dV; delta =
    rowsum(dout * out) in fp32; ds = p * (dp - delta) * scale, rounded to q's
    dtype for dQ and dK; products accumulate in fp32. Rows with nothing
    attended get ``_mea_bwd``'s gradients (``fix_unattended_bwd``).
    """
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    mask = _mask(sq, sk, causal, window, q_offset, q.device)
    delta = (dout.float() * out.float()).sum(-1)  # (B, Sq, Hq)
    dqs, dks, dvs = [], [], []
    for h, qg in _per_kv_head(q, hkv):
        heads = slice(h * g, (h + 1) * g)
        kh, vh, dog = k[:, :, h].float(), v[:, :, h].float(), dout[:, :, heads]
        s = torch.einsum("bqgd,bsd->bgqs", qg.float(), kh) * scale
        p = torch.exp(s - lse[:, heads, :, None])
        p = torch.where(mask, p, torch.zeros((), device=q.device))
        dv = torch.einsum("bgqs,bqgd->bsd", p.to(dout.dtype).float(), dog.float())
        dp = torch.einsum("bqgd,bsd->bgqs", dog.float(), vh)
        ds = p * (dp - delta[:, :, heads].permute(0, 2, 1)[..., None]) * scale
        dsd = ds.to(q.dtype).float()
        dqs.append(torch.einsum("bgqs,bsd->bqgd", dsd, kh))
        dks.append(torch.einsum("bgqs,bqgd->bsd", dsd, qg.float()))
        dvs.append(dv)
    dq = torch.cat(dqs, dim=2).to(q.dtype)
    dk = torch.stack(dks, dim=2).to(k.dtype)
    dv = torch.stack(dvs, dim=2).to(v.dtype)
    fix_unattended_bwd(q, k, v, out, dout, dq, dk, dv,
                       unattended_rows(sq, sk, causal, window, q_offset))
    return dq, dk, dv


def rmsnorm_bwd_ref(x, scale, dy, eps: float = 1e-6):
    """Gradients (dx, dscale) of ``rmsnorm_ref`` at (x, scale) for the
    cotangent dy, in fp32, cast to x's and scale's dtypes."""
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    n = (xf * r).to(x.dtype).float()
    dscale = (dyf * n).reshape(-1, x.shape[-1]).sum(0)
    dn = dyf * scale.float()
    dx = dn * r - xf * (r ** 3) * (dn * xf).mean(dim=-1, keepdim=True)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def fused_adam_ref(p, g, master, m, v, *, lr, b1, b2, eps, weight_decay, bc1, bc2):
    """Returns (p_new, master_new, m_new, v_new); new tensors, inputs untouched."""
    gf = g.float()
    m_new = b1 * m + (1 - b1) * gf
    v_new = b2 * v + (1 - b2) * gf * gf
    upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) + weight_decay * master
    master_new = master - lr * upd
    return master_new.to(p.dtype), master_new, m_new, v_new


def fused_quantize_ef_ref(ch: torch.Tensor, me: int):
    """The three-op sequence of ``src/repro/kernels/ref.py::fused_quantize_ef_ref``
    (per-chunk absmax int8 quantize plus the owned chunk's residual), verbatim.

    ch: (z, *shard), fp32 or bf16 (widened to fp32 first). Returns (q int8
    like ch, scales (z,) fp32, err fp32 like ch[0]): ``scale = max(max |x|,
    1e-30) / 127``, ``q = clip(round(x / scale), -127, 127)`` (round half to
    even), ``err = ch[me] - f32(q[me]) * scale[me]``.
    """
    ch = ch.float()
    z = ch.shape[0]
    amax = torch.clamp_min(ch.abs().amax(dim=tuple(range(1, ch.ndim))), 1e-30)
    # divide by a tensor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its fp32 reciprocal, which is not the IEEE quotient
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(ch / scale.reshape((z,) + (1,) * (ch.ndim - 1))),
                    -127, 127).to(torch.int8)
    own = ch[me]
    new_err = own - q[me].float() * scale[me]
    return q, scale, new_err
