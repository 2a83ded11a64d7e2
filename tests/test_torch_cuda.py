"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without an sm_90 card and nvcc. This file imports
only torch and the port, so it runs on a machine without JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Tolerance: bf16 outputs compared in fp32. RMSNorm: ``|k - p| <= 2e-2 * (1 +
|p|)`` (the repository's bf16 bound). Paged attention, whose outputs are
weighted means far below 1: ``|k - p| <= 2e-2 * max |p|`` over each (batch
row, head), a few bf16 roundings of that head's output. FlashAttention
forward and backward (``chip_smoke.py``'s bound; the backward is also
bitwise equal from one call to the next): O, dQ, dK and dV within
``2e-2 * max |p|`` over each (batch, row, head), since a causal row's scale
falls as 1/sqrt(q), plus ``1e-4 * max |p|`` over the (batch, head) for rows
near 0; the fp32 log-sum-exp within ``1e-4 * (1 + |p|)``
(fp32 sums in another order). Fused Adam: fp32 master, m and v within
``1e-6 * (|p| + max |p|)`` (a few ulps: the kernel's FMAs and division
order); bf16 p within one bf16 ulp, ``2^-7 * |p|``, plus the master's
bound. The fused int8 quantize: q, scales and the residual bitwise equal to
the plain version.
"""
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.compat import cuda_kernel_problems
from repro_torch.kernels import ref

import torch_cores

torch_cores.share_cores()

TOL = 2e-2


def _require_card():
    problems = cuda_kernel_problems()
    if problems:
        pytest.skip("needs an sm_90 card and nvcc: " + "; ".join(problems))


def _close(out, want):
    out, want = out.float(), want.float()
    return bool(((out - want).abs() <= TOL * (1 + want.abs())).all())


def _close_to_head_max(out, want, dims=-1):
    out, want = out.float(), want.float()
    return bool(((out - want).abs() <= TOL * want.abs().amax(dim=dims, keepdim=True)).all())


def _close_per_row(out, want):
    """(B, S, H, hd): within TOL * max |want| over each (batch, row, head),
    plus 1e-4 * max |want| over each (batch, head)."""
    out, want = out.float(), want.float()
    mag = want.abs()
    tol = TOL * mag.amax(dim=3, keepdim=True) + 1e-4 * mag.amax(dim=(1, 3), keepdim=True)
    return bool(((out - want).abs() <= tol).all())


# (rows, d, dtype): the decode step's 4 rows, 128, and a training
# microbatch's 4096 rows at d 4096 (512 threads, one 16-byte vector each);
# fp32 (1024 threads); the widths of configs/archs.py past 1024 vectors (two
# vectors a thread at 16384, the general path at 18432); a d off the
# 16-byte vector and a row that is not 16-byte aligned (the general path)
RMSNORM_CASES = [(4, 4096, torch.bfloat16), (128, 4096, torch.bfloat16),
                 (4096, 4096, torch.bfloat16), (4, 4096, torch.float32),
                 (3, 16384, torch.bfloat16), (5, 18432, torch.bfloat16),
                 (4, 4100, torch.bfloat16), (6, 1000, torch.float32),
                 (4, "unaligned", torch.bfloat16),
                 # mamba2-130m: d 768, the gated norm's 1536, decode and training rows
                 (4, 768, torch.bfloat16), (4, 1536, torch.bfloat16),
                 (32768, 1536, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype", RMSNORM_CASES)
def test_rmsnorm_kernel_matches_plain(rows, d, dtype):
    _require_card()
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    g = torch.Generator(device="cuda").manual_seed(rows)
    if d == "unaligned":  # rows start 2 elements past a 16-byte boundary
        d = 4096
        x = torch.randn(rows * d + 1, device="cuda", generator=g).to(dtype)[1:].view(rows, 1, d)
    else:
        x = torch.randn(rows, 1, d, device="cuda", generator=g).to(dtype)
    s = (1 + 0.1 * torch.randn(d, device="cuda", generator=g)).to(dtype)
    before = K.launch_counts()["rmsnorm"]
    out = K.fused_rmsnorm(x, s)
    torch.cuda.synchronize()
    assert K.launch_counts()["rmsnorm"] == before + 1
    assert _close(out, ref.rmsnorm_ref(x, s))
    # programmatic dependent launch changes when the kernel may start, not what it computes
    for pdl in (False, True):
        assert torch.equal(rmsnorm_cuda(x, s, pdl=pdl), out)


@pytest.mark.cuda
@pytest.mark.parametrize("cold_on_host", [False, True])
@pytest.mark.parametrize("g_heads,hd", [(4, 128), (1, 64), (8, 128)])
def test_paged_attention_kernel_matches_plain(cold_on_host, g_heads, hd):
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(hd + g_heads)
    b, hkv, s, w = 3, 2, 512, 128
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).bfloat16()  # noqa: E731
    q = rnd(b, 1, hkv * g_heads, hd)
    kh, vh, kc, vc = rnd(b, w, hkv, hd), rnd(b, w, hkv, hd), rnd(b, s, hkv, hd), rnd(b, s, hkv, hd)
    sel = torch.rand(b, s, device="cuda", generator=gen) < 0.5
    pos = torch.tensor([0, 200, 511], device="cuda")[:, None]
    mask = torch.where(torch.arange(s, device="cuda")[None] <= pos, 0.0, -1e30)
    if cold_on_host:
        kc, vc = kc.cpu().pin_memory(), vc.cpu().pin_memory()
    out = K.decode_paged_attention(q, kh, vh, kc, vc, sel, mask, n_hot=2)
    want = ref.paged_attention_ref(q, kh, vh, kc, vc, sel, mask)
    torch.cuda.synchronize()
    assert _close_to_head_max(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("g_heads,hd", [(4, 128), (8, 64), (1, 128)])
def test_paged_attention_kernel_fp32_matches_plain(g_heads, hd):
    """The fp32 instantiations (4 values a 16-byte load: a 128-wide row is
    one warp instruction) over several splits, cold store pinned."""
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(g_heads * hd)
    b, hkv, s, w = 2, 2, 768, 128
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)  # noqa: E731
    q = rnd(b, 1, hkv * g_heads, hd)
    kh, vh = rnd(b, w, hkv, hd), rnd(b, w, hkv, hd)
    kc, vc = rnd(b, s, hkv, hd).cpu().pin_memory(), rnd(b, s, hkv, hd).cpu().pin_memory()
    sel = torch.rand(b, s, device="cuda", generator=gen) < 0.5
    pos = torch.tensor([300, s - 1], device="cuda")[:, None]
    mask = torch.where(torch.arange(s, device="cuda")[None] <= pos, 0.0, -1e30)
    out = K.decode_paged_attention(q, kh, vh, kc, vc, sel, mask, n_hot=2)
    want = ref.paged_attention_ref(q, kh, vh, kc, vc, sel, mask)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert _close_to_head_max(out, want)


@pytest.mark.cuda
def test_paged_attention_kernel_refuses_pageable_cold():
    _require_card()
    q = torch.zeros(1, 1, 4, 128, device="cuda", dtype=torch.bfloat16)
    hot = torch.zeros(1, 64, 1, 128, device="cuda", dtype=torch.bfloat16)
    cold = torch.zeros(1, 128, 1, 128, dtype=torch.bfloat16)  # pageable host memory
    sel = torch.zeros(1, 128, device="cuda", dtype=torch.bool)
    mask = torch.zeros(1, 128, device="cuda")
    with pytest.raises(ValueError, match="pinned"):
        K.decode_paged_attention(q, hot, hot, cold, cold, sel, mask, n_hot=1)


@pytest.mark.cuda
@pytest.mark.parametrize("cold_on_host", [False, True])
def test_paged_attention_kernel_long_rows_match_plain(cold_on_host):
    """S 65,536 at G 4, hd 128: shared memory does not grow with S, so long
    caches run (whole pages a split, the last one ragged)."""
    _require_card()
    from repro_torch.kernels.paged_attention import split_rows

    gen = torch.Generator(device="cuda").manual_seed(65536)
    b, hkv, g, hd, s, page, n_hot = 2, 2, 4, 128, 65536, 256, 2
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).bfloat16()  # noqa: E731
    q = rnd(b, 1, hkv * g, hd)
    kh, vh = rnd(b, page * n_hot, hkv, hd), rnd(b, page * n_hot, hkv, hd)
    kc, vc = rnd(b, s, hkv, hd), rnd(b, s, hkv, hd)
    sel = torch.rand(b, s, device="cuda", generator=gen) < 0.5
    pos = torch.tensor([40_000, s - 1], device="cuda")[:, None]
    mask = torch.where(torch.arange(s, device="cuda")[None] <= pos, 0.0, -1e30)
    if cold_on_host:
        kc, vc = kc.cpu().pin_memory(), vc.cpu().pin_memory()
    rows, n_split = split_rows(b, hkv, s, page, torch.cuda.get_device_properties(0)
                               .multi_processor_count)
    assert n_split > 1
    out = K.decode_paged_attention(q, kh, vh, kc, vc, sel, mask, n_hot=n_hot)
    want = ref.paged_attention_ref(q, kh, vh, kc, vc, sel, mask)
    torch.cuda.synchronize()
    assert _close_to_head_max(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_split", [64, 192, 1408])
@pytest.mark.parametrize("mask_case", ["causal", "masked_split", "all_masked", "one_row"])
def test_paged_attention_kernel_forced_splits(monkeypatch, rows_per_split, mask_case):
    """Splits forced through the wrapper's choice: many one-page splits, a
    ragged last split (1408 = 7 * 192 + 64) and one split, each under a
    causal mask, a wholly masked first half, every row masked and one
    attendable row; against the plain version and the split model."""
    _require_card()
    from repro_torch.kernels import paged_attention as PA

    b, hkv, g, hd, s, page = 3, 2, 4, 128, 1408, 64
    monkeypatch.setattr(PA, "split_rows",
                        lambda *args: (rows_per_split, -(-s // rows_per_split)))
    gen = torch.Generator(device="cuda").manual_seed(rows_per_split)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).bfloat16()  # noqa: E731
    q = rnd(b, 1, hkv * g, hd)
    kh, vh = rnd(b, 2 * page, hkv, hd), rnd(b, 2 * page, hkv, hd)
    kc, vc = rnd(b, s, hkv, hd), rnd(b, s, hkv, hd)
    sel = torch.rand(b, s, device="cuda", generator=gen) < 0.5
    mask = torch.zeros(b, s, device="cuda")
    if mask_case == "causal":
        pos = torch.tensor([0, 700, s - 1], device="cuda")[:, None]
        mask = torch.where(torch.arange(s, device="cuda")[None] <= pos, 0.0, -1e30)
    elif mask_case == "masked_split":
        mask[:, : s // 2] = -1e30
    elif mask_case == "all_masked":
        mask[:] = -1e30
    else:
        mask[:] = -1e30
        mask[:, s // 2 + 1] = 0.0
    out = K.decode_paged_attention(q, kh, vh, kc, vc, sel, mask, n_hot=2)
    args = (q, kh, vh, kc, vc, sel, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert _close_to_head_max(out, ref.paged_attention_ref(*args))
    assert _close_to_head_max(out, ref.paged_attention_split_ref(*args, rows_per_split))


def _attn_inputs(seed, b, s, hq, hkv, hd):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).bfloat16()  # noqa: E731
    return rnd(b, s, hq, hd), rnd(b, s, hkv, hd), rnd(b, s, hkv, hd), rnd(b, s, hq, hd)


FLASH_CASES = [  # (b, s, hq, hkv, hd, causal, window)
    (2, 200, 8, 2, 128, True, 0),
    (1, 300, 4, 4, 64, True, 64),
    (2, 130, 8, 1, 128, False, 0),
    (1, 513, 8, 2, 128, True, 100),
    # the backward's tile edges: S off its 64-row tiles, windows off them,
    # G 8, hd 64
    (1, 1000, 16, 2, 64, True, 100),
    (2, 333, 16, 2, 128, True, 77),
    (1, 96, 8, 1, 64, True, 0),
    (1, 70, 8, 1, 128, False, 0),
    # group 7 (llava-next-34b: 56 over 8 heads of 128)
    (1, 517, 14, 2, 128, True, 0),
    (2, 200, 7, 1, 128, False, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(b, s, hq, hkv, hd, causal, window):
    _require_card()
    q, k, v, dout = _attn_inputs(s + hd, b, s, hq, hkv, hd)
    before = K.launch_counts()
    out, lse = K.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=causal, window=window).transpose(1, 2)
    _, want_lse = ref.attention_lse_ref(q, k, v, causal=causal, window=window)
    model, model_lse = ref.flash_attention_tiled_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert K.launch_counts()["flash_attention"] == before["flash_attention"] + 1
    assert _close_per_row(out, want)
    assert bool(((lse - want_lse).abs() <= 1e-4 * (1 + want_lse.abs())).all())
    assert _close_per_row(out, model)
    assert bool(((lse - model_lse).abs() <= 1e-4 * (1 + model_lse.abs())).all())

    grads = K.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, window=window)
    wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window)
    torch.cuda.synchronize()
    assert K.launch_counts()["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    for got, exp in zip(grads, wants):
        assert got.shape == exp.shape and got.dtype == exp.dtype
        assert _close_per_row(got, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,hd", [
    (16, 16, 128),  # gpt2-1b's heads (group 1): one query head a block, 64-key tiles
    (40, 40, 128),  # opt-13b's and llama-13b's heads (group 1)
    (6, 2, 64),     # group 3: one head a block
    (6, 2, 128),
    (8, 2, 64),     # group 4: two heads a block sharing 128-key tiles
    (32, 8, 128),   # mistral-7b's heads
])
def test_flash_attention_kernel_block_shapes(hq, hkv, hd):
    """The kernel takes one query head a block when the kv group is odd and
    two, sharing 128-key tiles, when it is even; each against the plain
    version and the tiled model with that key tile."""
    _require_card()
    q, k, v, _ = _attn_inputs(hq + hd, 2, 333, hq, hkv, hd)
    kw = dict(causal=True, window=77)
    out, lse = K.flash_attention(q, k, v, **kw)
    want, want_lse = ref.attention_lse_ref(q, k, v, **kw)
    model, model_lse = ref.flash_attention_tiled_ref(
        q, k, v, key_tile=128 if (hq // hkv) % 2 == 0 else 64, **kw)
    torch.cuda.synchronize()
    for exp, exp_lse in ((want, want_lse), (model, model_lse)):
        assert _close_per_row(out, exp)
        assert bool(((lse - exp_lse).abs() <= 1e-4 * (1 + exp_lse.abs())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,hq,hkv,hd,window,q_offset", [
    (150, 60, 8, 2, 128, 40, 37),   # rows 62..149 attend no key; whole query tiles have none
    (100, 164, 8, 2, 64, 0, 64),    # queries at 64..163 over 164 keys
    (70, 333, 6, 2, 128, 77, 263),  # group 3: one head a block; window off the tiles
    (90, 50, 8, 2, 128, 0, -30),    # rows 0..29 at negative positions
])
def test_flash_attention_kernel_offset_and_unattended_rows(sq, sk, hq, hkv, hd, window, q_offset):
    """Sk != Sq with a query offset: the kernel against the whole-row plain
    version and the tiled model; rows with no attended key get the JAX
    references' values, as the plain versions (held to _mea and the Pallas
    kernel in tests/test_torch_kernels.py) give them: out the mean of V over
    the keys padded to the Pallas tile (128), lse -1e30, and _mea_bwd's
    gradients."""
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(sq + sk)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).bfloat16()  # noqa: E731
    q, k, v, dout = rnd(1, sq, hq, hd), rnd(1, sk, hkv, hd), rnd(1, sk, hkv, hd), rnd(1, sq, hq, hd)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    out, lse = K.flash_attention(q, k, v, **kw)
    want, want_lse = ref.attention_lse_ref(q, k, v, **kw)
    model, model_lse = ref.flash_attention_tiled_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    for exp, exp_lse in ((want, want_lse), (model, model_lse)):
        assert _close_per_row(out, exp)
        assert bool(((lse - exp_lse).abs() <= 1e-4 * (1 + exp_lse.abs())).all())
    attended = ref._mask(sq, sk, True, window, q_offset, "cuda").any(dim=1)
    n_keys = -(-sk // min(128, sk)) * min(128, sk)
    mean = (v.float().sum(dim=1) / n_keys).repeat_interleave(hq // hkv, dim=1)  # (1, Hq, hd)
    if not attended.all():
        assert _close_per_row(out[:, ~attended], mean[:, None].expand_as(out[:, ~attended]))
        assert bool((lse[:, :, ~attended] == -1e30).all())
    grads = K.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for got, exp in zip(grads, wants):
        assert _close_per_row(got, exp)
    if not attended.all():
        assert grads[0][:, ~attended].float().abs().amax() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("q_offset", [0, 37])
def test_flash_attention_bwd_is_deterministic(q_offset):
    """Two backward calls on the same inputs agree bit for bit (no atomics),
    and a query offset (queries at q + q_offset) matches the plain version."""
    _require_card()
    b, s, hq, hkv, hd, window = 1, 777, 16, 2, 128, 300
    q, k, v, dout = _attn_inputs(q_offset + 5, b, s, hq, hkv, hd)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    out, lse = K.flash_attention(q, k, v, **kw)
    first = K.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    second = K.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for a, c, want in zip(first, second, wants):
        assert torch.equal(a.view(torch.int16), c.view(torch.int16))
        assert _close_per_row(a, want)


@pytest.mark.cuda
@pytest.mark.parametrize("on_host", [False, True])
@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32])
def test_fused_adam_kernel_matches_plain(on_host, g_dtype):
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    n = (1000, 37)  # 37,000 elements: whole groups of 4 and no tail; + a tail case below
    for shape in (n, (5, 7)):
        master = torch.randn(*shape, device="cuda", generator=gen)
        g = torch.randn(*shape, device="cuda", generator=gen).to(g_dtype)
        m = 0.1 * torch.randn(*shape, device="cuda", generator=gen)
        v = 0.01 * torch.rand(*shape, device="cuda", generator=gen)
        p = master.bfloat16()
        hp = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, bc1=0.271, bc2=0.142625)
        scalars = torch.tensor([hp["lr"], hp["b1"], hp["b2"], hp["eps"], hp["weight_decay"],
                                hp["bc1"], hp["bc2"], 0.0], device="cuda")
        want = ref.fused_adam_ref(p, g, master, m, v, **hp)
        states = [t.clone() for t in (master, m, v)]
        if on_host:
            states = [t.cpu().pin_memory() for t in states]
        out = K.fused_adam_update(p.clone(), g, *states, scalars)
        torch.cuda.synchronize()
        p_tol = 2.0 ** -7 * want[0].float().abs() + 2e-6 * want[1].abs().max()
        assert bool(((out[0].float() - want[0].float()).abs() <= p_tol).all())
        for got, exp in zip(out[1:], want[1:]):
            assert got.device == (torch.device("cpu") if on_host else exp.device)
            got = got.to(exp.device)
            assert bool(((got - exp).abs() <= 1e-6 * (exp.abs() + exp.abs().max())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,pinned_p", [
    (4096, True),                  # less than one segment, a pinned p
    (1 << 20, False),              # one whole segment
    (2 << 20, False),              # two whole segments
    ((1 << 20) + 1027, True),      # a tail off a multiple of 4, a pinned p
    (2 * (1 << 20) + 12, False),   # two segments and a ragged tail
])
def test_fused_adam_pinned_pipeline_matches_device_kernel_bitwise(n, pinned_p):
    """States in pinned memory (and a pinned p) go through the copy-engine
    pipeline, one kernel launch a segment; the result equals the same kernel
    on device copies of the same inputs, bit for bit, and is in the pinned
    tensors when the current stream is done."""
    _require_card()
    from repro_torch.kernels import fused_adam

    gen = torch.Generator(device="cuda").manual_seed(n)
    master = torch.randn(n, device="cuda", generator=gen)
    g = torch.randn(n, device="cuda", generator=gen).bfloat16()
    m = 0.1 * torch.randn(n, device="cuda", generator=gen)
    v = 0.01 * torch.rand(n, device="cuda", generator=gen)
    p = master.bfloat16()
    scalars = torch.tensor([3e-4, 0.9, 0.95, 1e-8, 0.1, 0.271, 0.142625, 0.0], device="cuda")
    want = K.fused_adam_update(p.clone(), g, master.clone(), m.clone(), v.clone(), scalars)
    host = [t.cpu().pin_memory() for t in (p, master, m, v)]
    if not pinned_p:
        host[0] = p.clone()
    before = K.launch_counts()["fused_adam"]
    got = K.fused_adam_update(host[0], g, *host[1:], scalars)
    torch.cuda.current_stream().synchronize()  # the write-back is ordered on this stream
    assert K.launch_counts()["fused_adam"] == before + len(fused_adam.segments(n))
    assert fused_adam.staging_bytes(g.device) == fused_adam.SLOTS * 16 * fused_adam.SEGMENT
    assert all(a is h for a, h in zip(got, host))  # updated in place
    for a, b in zip(got, want):
        a = a.to(b.device)
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(a.view(bits), b.view(bits))


@pytest.mark.cuda
def test_fused_adam_kernel_refuses_pageable_states():
    _require_card()
    p = torch.zeros(8, device="cuda", dtype=torch.bfloat16)
    dev = torch.zeros(8, device="cuda")
    scalars = torch.ones(8, device="cuda")
    with pytest.raises(ValueError, match="pinned"):
        K.fused_adam_update(p, dev, torch.zeros(8), dev, dev, scalars)


# query rows, key rows, heads (query, KV), hd: seamless-m4t-large-v2's
# group 1 at hd 64, non-causal (the encoder's self-attention and the
# decoder's cross-attention), query and key rows apart and off the tiles
FLASH_FULL_CASES = [(256, 256, 16, 16, 64), (300, 1000, 16, 16, 64), (1000, 300, 16, 16, 64),
                    (77, 513, 4, 4, 64), (1024, 4096, 16, 16, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,hq,hkv,hd", FLASH_FULL_CASES)
def test_flash_attention_kernel_unmasked_rows_apart_match_plain(sq, sk, hq, hkv, hd):
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(sq + sk)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).bfloat16()  # noqa: E731
    q, k, v, dout = rnd(1, sq, hq, hd), rnd(1, sk, hkv, hd), rnd(1, sk, hkv, hd), rnd(1, sq, hq, hd)
    out, lse = K.flash_attention(q, k, v, causal=False)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=False).transpose(1, 2)
    _, want_lse = ref.attention_lse_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert _close_per_row(out, want)
    assert bool(((lse - want_lse).abs() <= 1e-4 * (1 + want_lse.abs())).all())
    grads = K.flash_attention_bwd(q, k, v, out, lse, dout, causal=False)
    wants = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=False)
    torch.cuda.synchronize()
    for got, exp in zip(grads, wants):
        assert got.shape == exp.shape and _close_per_row(got, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("cold_on_host", [False, True])
def test_paged_attention_kernel_seamless_heads_match_plain(cold_on_host):
    """seamless-m4t-large-v2's decoder: 16 query over 16 KV heads of 64."""
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(64)
    b, h, hd, s, w = 4, 16, 64, 1024, 512
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).bfloat16()  # noqa: E731
    q = rnd(b, 1, h, hd)
    kh, vh, kc, vc = rnd(b, w, h, hd), rnd(b, w, h, hd), rnd(b, s, h, hd), rnd(b, s, h, hd)
    sel = torch.rand(b, s, device="cuda", generator=gen) < 0.5
    pos = torch.tensor([595, 640, 700, 773], device="cuda")[:, None]
    mask = torch.where(torch.arange(s, device="cuda")[None] <= pos, 0.0, -1e30)
    if cold_on_host:
        kc, vc = kc.cpu().pin_memory(), vc.cpu().pin_memory()
    out = K.decode_paged_attention(q, kh, vh, kc, vc, sel, mask, n_hot=2)
    want = ref.paged_attention_ref(q, kh, vh, kc, vc, sel, mask)
    torch.cuda.synchronize()
    assert _close_to_head_max(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cold_on_host", [False, True])
def test_paged_attention_kernel_llava_group_matches_plain(cold_on_host):
    """llava-next-34b's decode: 56 query over 8 KV heads of 128 (group 7),
    B 4 over a 1024-row cache, at mid-run positions past the hot window."""
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    b, hq, hkv, hd, s, w = 4, 56, 8, 128, 1024, 512
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).bfloat16()  # noqa: E731
    q = rnd(b, 1, hq, hd)
    kh, vh, kc, vc = rnd(b, w, hkv, hd), rnd(b, w, hkv, hd), rnd(b, s, hkv, hd), rnd(b, s, hkv, hd)
    sel = torch.rand(b, s, device="cuda", generator=gen) < 0.5
    pos = torch.tensor([595, 640, 700, 773], device="cuda")[:, None]
    mask = torch.where(torch.arange(s, device="cuda")[None] <= pos, 0.0, -1e30)
    if cold_on_host:
        kc, vc = kc.cpu().pin_memory(), vc.cpu().pin_memory()
    out = K.decode_paged_attention(q, kh, vh, kc, vc, sel, mask, n_hot=2)
    want = ref.paged_attention_ref(q, kh, vh, kc, vc, sel, mask)
    torch.cuda.synchronize()
    assert _close_to_head_max(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mistral-7b", "gpt2-1b", "seamless-m4t-large-v2"])
def test_train_step_runs_on_card(arch):
    """Two steps of a small bf16 model through the training kernels (gpt2:
    tied embeddings, LayerNorm, MHA; seamless: an encoder over frames and
    the decoder's cross-attention, hd 64), with a host chunk's states
    pinned."""
    _require_card()
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import MemoryPlan
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.train.step_builder import build_train_step

    cfg = reduced(get_config(arch), head_dim=64, num_kv_heads=2)
    shape = ShapeConfig("card", 256, 2, "train")
    plan = MemoryPlan(4, 2, n_persist=2, n_host=1, n_checkpoint=1, microbatch=2,
                      host_params=False)
    art = build_train_step(cfg, plan, "cuda", shape)
    state = art.init(torch.Generator(device="cuda").manual_seed(0))
    assert state["opt"]["master"]["final_norm"]["scale"].is_pinned()  # the head chunk's
    pipe = SyntheticTokenPipeline(cfg, shape, device="cuda")
    before = K.launch_counts()
    for _ in range(2):
        state, metrics = art.fn(state, pipe.next_sync())
        assert torch.isfinite(metrics["loss"]).item()
    after = K.launch_counts()
    for name in ("flash_attention", "flash_attention_bwd", "fused_adam"):
        assert after[name] > before[name], name


# (case, z, n, dtype) of the quantizer's card cases: bf16 activation rows at
# d 4096 and at mamba2-130m's d 768 (a warp a row); the widest configs' rows,
# d 16384 (llama3-405b) and 18432 (nemotron-4-340b), which must run as one
# kernel; d 18432 in fp32; bf16 rows with n % 8 == 4 (8-byte loads); 257
# rows (not a whole number of 8-row blocks); one row; edge rows (a zero row,
# exact half-way quotients, the clip bound, n not a multiple of 4); long
# fp32 rows (the two-pass path)
QUANT_CASES = [("activation", 256, 4096, torch.bfloat16),
               ("narrow_activation", 256, 768, torch.bfloat16),
               ("rows_16384", 64, 16384, torch.bfloat16),
               ("rows_18432", 64, 18432, torch.bfloat16),
               ("fp32_activation", 64, 18432, torch.float32),
               ("bf16_n8_4", 32, 4100, torch.bfloat16),
               ("rows_257", 257, 768, torch.bfloat16),
               ("single_row", 1, 18432, torch.bfloat16),
               ("edges", 4, 131, torch.float32),
               ("long_rows", 3, 50_001, torch.float32)]


def _graph_kernel_nodes(fn) -> int:
    """Kernel nodes of a CUDA graph that captures one call of ``fn`` (counted
    in the graph: torch.profiler can miss the library's launches in short
    traces)."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    rt = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    assert rt.cudaGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert rt.cudaGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    kinds = [ctypes.c_int(-1) for _ in nodes]
    for node, kind in zip(nodes, kinds):
        assert rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
    graph.reset()
    assert all(k.value == 0 for k in kinds), [k.value for k in kinds]  # kernel nodes only
    return len(kinds)


@pytest.mark.cuda
@pytest.mark.parametrize("case,z,n,dtype", QUANT_CASES, ids=[c[0] for c in QUANT_CASES])
def test_fused_quantize_ef_kernel_matches_plain_bitwise(case, z, n, dtype):
    """The kernel's q, scales and residual bitwise equal to the plain
    version's; at d 16384 and 18432 one call is one kernel (x read once)."""
    _require_card()
    from repro_torch.kernels.fused_quant import quant_plan

    g = torch.Generator(device="cuda").manual_seed(3)
    if case == "edges":
        ties = torch.zeros(n, device="cuda")
        ties[0] = 127.0
        ties[1:9] = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5])
        ties[9] = -0.0  # the residual keeps the sign of x
        x = torch.stack([torch.zeros(n, device="cuda"), ties,
                         torch.linspace(-3.3, 3.3, n, device="cuda"),
                         torch.randn(n, device="cuda", generator=g)])
        me = 1
    else:
        x = (torch.randn(z, n, device="cuda", generator=g)
             * torch.exp(torch.randn(z, 1, device="cuda", generator=g))).to(dtype)
        me = z - 1
    got = K.fused_quantize_ef(x, me)
    want = ref.fused_quantize_ef_ref(x, me)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if case == "edges":
        assert got[0][1, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]
    if case in ("rows_16384", "rows_18432", "fp32_activation"):
        assert quant_plan(z, n, dtype).passes == 1
        assert _graph_kernel_nodes(lambda: K.fused_quantize_ef(x, me)) == 1


@pytest.mark.cuda
def test_compress8_swap_host_weights_step_runs_on_card():
    """Two steps of a small bf16 mistral under compress8 and swap layers with
    the last block's and the head's weights in pinned host memory: finite
    losses, the quantizer launched at three sites per compress8 layer and
    microbatch, the host weights pinned."""
    _require_card()
    from repro_torch import obs
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import MemoryPlan
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.train.step_builder import build_train_step

    cfg = reduced(get_config("mistral-7b"), head_dim=64, num_kv_heads=2)
    shape = ShapeConfig("card", 256, 2, "train")
    plan = MemoryPlan(4, 2, n_persist=1, n_host=2, host_params=True, n_buffer=1, microbatch=2,
                      act_policies=("compress8", "swap"))
    tel = obs.Telemetry()
    art = build_train_step(cfg, plan, "cuda", shape, telemetry=tel)
    state = art.init(torch.Generator(device="cuda").manual_seed(0))
    assert state["params"]["head"]["w"].is_pinned() and state["params"]["runs"][1][
        "pos0"]["attn"]["wq"].is_pinned()
    pipe = SyntheticTokenPipeline(cfg, shape, device="cuda")
    before = K.launch_counts()["fused_quantize_ef"]
    for _ in range(2):
        state, metrics = art.fn(state, pipe.next_sync())
        assert torch.isfinite(metrics["loss"]).item()
    assert K.launch_counts()["fused_quantize_ef"] - before == 2 * 2 * 3
    snap = tel.registry.snapshot()
    assert snap["train.act_swap_out_bytes"]["value"] == snap["train.act_swap_in_bytes"]["value"] > 0
    assert snap["train.weight_fetch_bytes"]["value"] > 0 and snap["train.act_bytes"]["value"] > 0


def _blocks_as_runs(params, runs):
    """A copy of a tree with stacked ``blocks`` as the state tree of a run
    layout (a copy: the step updates its state in place)."""
    out = {k: _slice_blocks(v, 0, None) for k, v in params.items() if k != "blocks"}
    out["runs"] = [{k: _slice_blocks(v, r.start, r.length) for k, v in params["blocks"].items()}
                   for r in runs]
    return out


def _slice_blocks(tree, start, length):
    if isinstance(tree, torch.Tensor):
        return (tree if length is None else tree[start:start + length]).clone()
    return {k: _slice_blocks(v, start, length) for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("n_buffer,policies", [(0, ("none", "none")),
                                               (1, ("checkpoint", "none")),
                                               (0, ("compress8", "swap"))])
def test_host_weights_step_equals_device_weights_on_card(n_buffer, policies):
    """Two steps of a small bf16 mistral with both blocks and the head in
    pinned host memory give the same losses and weights, bitwise, as the
    same plan with every chunk on the card (one init); the weight bytes
    fetched are the plan's: every host chunk once per microbatch, an
    unbuffered block once more for its backward (a ``none`` block through
    the saved-tensor re-fetch, a recomputed one in its replay)."""
    _require_card()
    from repro_torch import obs
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import MemoryPlan
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.models import model as M
    from repro_torch.optim.adam import tree_leaves
    from repro_torch.train.step_builder import build_train_step

    cfg = reduced(get_config("mistral-7b"), head_dim=64, num_kv_heads=2)
    shape = ShapeConfig("card", 256, 2, "train")
    init = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    kw = dict(n_persist=1, microbatch=2, act_policies=policies)
    out = {}
    for name, plan in (("device", MemoryPlan(4, 2, **kw)),
                       ("host", MemoryPlan(4, 2, n_host=3, host_params=True, n_buffer=n_buffer,
                                           **kw))):
        tel = obs.Telemetry()
        art = build_train_step(cfg, plan, "cuda", shape, telemetry=tel)
        state = art.place_state(_blocks_as_runs(init, art.runs))
        pipe = SyntheticTokenPipeline(cfg, shape, seed=0, device="cuda")
        losses = [float(art.fn(state, pipe.next_sync())[1]["loss"]) for _ in range(2)]
        blocks = [torch.cat(xs) for xs in zip(*(tree_leaves(r) for r in state["params"]["runs"]))]
        out[name] = (losses, [t.cpu() for t in blocks + tree_leaves(state["params"]["head"])],
                     tel.registry.snapshot()["train.weight_fetch_bytes"]["value"], plan)
    (dev_losses, dev_w, _, _), (losses, w, fetched, plan) = out["device"], out["host"]
    assert losses == dev_losses
    assert all(torch.equal(a, b) for a, b in zip(w, dev_w))
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    per_block = nbytes(tree_leaves(init["blocks"])) // 2
    head = nbytes(tree_leaves(init["final_norm"]) + tree_leaves(init["head"]))
    refetched = sum(1 for c in (1, 2) if not plan.chunk_buffered(c)) * per_block
    assert fetched == 2 * 2 * (2 * per_block + head + refetched)


# ---------------------------------------------------------------------------
# Serving from a CUDA graph
# ---------------------------------------------------------------------------
def _serve_setup(seq_len=256, batch=4):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, reduced
    from repro_torch.core.plan import MemoryPlan
    from repro_torch.models import kvcache as KV
    from repro_torch.models.model import init_params, num_repeats
    from repro_torch.serve import choose_paging

    # mistral-7b's family at a small width the kernels take: hd 128, 4 query
    # heads over 2 KV heads, a 64-slot sliding ring in 16-row pages, 2 hot
    cfg = dataclasses.replace(reduced(get_config("mistral-7b"), num_kv_heads=2), d_model=512,
                              head_dim=128, dtype="bfloat16")
    shape = ShapeConfig("serve", seq_len, batch, "decode")
    spec = choose_paging(KV.cache_len(cfg, seq_len), 16, 2)
    n = num_repeats(cfg) + 2
    plan = MemoryPlan(n, num_repeats(cfg), n_persist=n, n_host=spec.n_cold)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    return cfg, shape, spec, plan, params


@pytest.mark.cuda
def test_engine_graph_tokens_and_launches_equal_eager():
    """The engine serving from its CUDA graph gives the tokens, the kernels'
    launch counts (recorded at capture, added per replay) and the host-link
    bytes of the same engine launching every step from Python."""
    _require_card()
    import numpy as np

    from repro_torch.serve import DecodeEngine, Request

    cfg, shape, spec, plan, params = _serve_setup()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist() for n in (40, 97, 150, 71)]
    runs = {}
    for graphs in (True, False):
        eng = DecodeEngine(cfg, plan, "cuda", shape, params, paging=spec, own_params=True,
                           admission="chunked", prefill_chunk=16, graphs=graphs)
        assert (eng.serve_step.graph is not None) == graphs
        eng.warmup()
        K.reset_launch_counts()
        rep = eng.run([Request(i, p, 6) for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        assert rep.drained
        runs[graphs] = (rep.finished, K.launch_counts(), eng.kv_io.h2d_bytes)
    assert runs[True] == runs[False]
    launches = runs[True][1]
    per_step = {"paged_attention": cfg.num_layers, "rmsnorm": 2 * cfg.num_layers + 1}
    assert launches["paged_attention"] > 0
    assert launches["rmsnorm"] * per_step["paged_attention"] == \
        launches["paged_attention"] * per_step["rmsnorm"]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged_flush", "paged_write_through", "resident_full"])
def test_captured_step_equals_eager_step_bitwise(layout):
    """One step replayed from its graph against the same step launched from
    Python, on clones of one state: the logits and every cache leaf bit for
    bit (the same kernels on the same inputs in the same order). The last
    chunk ends at the cache end, so a full cache's inactive steps run past
    it (and write nothing); write-through's cold rows, written by the step
    through the pinned store's device view, hold the ring's bytes."""
    _require_card()
    import dataclasses

    from repro_torch.models import kvcache as KV
    from repro_torch.serve import init_paged_cache
    from repro_torch.serve.paging import PagedKV
    from repro_torch.serve.prefill import ServeStep

    cfg, shape, spec, plan, params = _serve_setup()
    if layout == "resident_full":
        cfg = dataclasses.replace(cfg, sliding_window=0)
        caches = [KV.init_cache(cfg, shape.global_batch, shape.seq_len, "cuda") for _ in range(2)]
        ios = [KV.RESIDENT_KV] * 2
    else:
        caches = [init_paged_cache(cfg, shape.global_batch, shape.seq_len, spec, "cuda")
                  for _ in range(2)]
        ios = [PagedKV(spec, flush=layout == "paged_flush") for _ in range(2)]
    steps = [ServeStep(params, c, cfg, io, batch=4, chunk=8, device="cuda", graph=g)
             for c, io, g in zip(caches, ios, (True, False))]
    gen = torch.Generator().manual_seed(1)
    for pos, n_tok in (([0, 3, 9, 14], [8, 8, 5, 8]), ([8, 11, 17, 22], [8, 8, 5, 8]),
                       ([70, 75, 81, 86], [8, 8, 5, 8]), ([248, 250, 252, 254], [8, 6, 4, 2])):
        block = torch.randint(1, cfg.vocab_size, (4, 8), generator=gen)
        for st in steps:
            st.run(block, pos, n_tok)
        torch.cuda.synchronize()
        assert torch.equal(steps[0].last.view(torch.int16), steps[1].last.view(torch.int16))
        assert torch.equal(steps[0].next_tok, steps[1].next_tok)
    for name, entry in caches[0].items():
        for key, leaf in entry.items():
            assert torch.equal(leaf.view(torch.int16), caches[1][name][key].view(torch.int16))
    if layout == "paged_write_through":
        entry = caches[0]["pos0"]
        for b, (p, n) in enumerate(zip(pos, n_tok)):
            for row in range(p, p + n):
                for name in ("k", "v"):
                    assert torch.equal(entry[f"{name}_cold"][:, b, row % spec.cache_len],
                                       entry[f"{name}_hot"][:, b, row % spec.hot_window].cpu())


# The port's profile of one mistral-7b superblock at B 1, S 4096 on the CPU
# (tests/test_torch_planner.py holds it to the reference): the trace runs on
# fake CPU tensors, so a machine with a card must give the same numbers.
MISTRAL_BLOCK_PROFILE = dict(flops_fwd=2064375300608.0, hbm_bytes_fwd=40026731584,
                             act_residual_bytes=1317569536, boundary_bytes=33554432,
                             peak_transient_bytes=1628446720)


@pytest.mark.cuda
def test_local_cuda_hw_reads_the_card_and_profile_is_device_free():
    import dataclasses
    import os

    from repro_torch.configs import get_config
    from repro_torch.core.hardware import H100_SXM, local_cuda_hw
    from repro_torch.core.profiler import profile_superblock

    _require_card()
    hw = local_cuda_hw()
    props = torch.cuda.get_device_properties(0)
    assert hw.hbm_bytes == props.total_memory
    assert hw.host_mem_bytes == os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert 1e9 < hw.host_bw < 2 * H100_SXM.host_bw  # measured, not the data sheet's
    assert (hw.peak_flops, hw.hbm_bw) == (H100_SXM.peak_flops, H100_SXM.hbm_bw)
    before = torch.cuda.memory_allocated()
    prof = profile_superblock(get_config("mistral-7b"), 1, 4096)
    assert dataclasses.asdict(prof) == MISTRAL_BLOCK_PROFILE
    assert torch.cuda.memory_allocated() == before  # fake tensors: nothing on the card


# ---------------------------------------------------------------------------
# The MoE family on the card
# ---------------------------------------------------------------------------
def _moe_cfg(cf=1.25, dtype="bfloat16"):
    """Reduced qwen2-moe-a2.7b at widths the kernels take: 4 query heads over
    4 KV heads (group 1, as the full model), hd 128, no window; 4 experts,
    top 2, 4 shared experts."""
    import dataclasses

    from repro_torch.configs import get_config, reduced

    cfg = reduced(get_config("qwen2-moe-a2.7b"), head_dim=128, d_model=256, dtype=dtype)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_layer_on_card_matches_cpu(cf):
    """``apply_moe`` in fp32 on the card against the CPU: the same routing
    and capacity drops, outputs and aux loss within 1e-5 (no TF32: the
    dispatch carries x's values exactly), gradients within 1e-4 of each
    leaf's largest."""
    _require_card()
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import init_tree

    cfg = _moe_cfg(cf, "float32")
    assert not torch.backends.cuda.matmul.allow_tf32
    params = init_tree(MOE.moe_defs(cfg), torch.Generator().manual_seed(0), "cpu")
    params = {k: v.float() for k, v in params.items()}
    x = torch.randn(4, 64, cfg.d_model, generator=torch.Generator().manual_seed(1))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
        xx = x.to(dev).requires_grad_()
        out, aux = MOE.apply_moe(p, xx, cfg)
        grads = torch.autograd.grad((out * out).sum() + aux, [xx] + [p[k] for k in sorted(p)])
        outs[dev] = [t.detach().cpu() for t in (out, aux, *grads)]
    for a, b in zip(outs["cuda"][:2], outs["cpu"][:2]):
        assert ((a - b).abs() <= 1e-5 * (1 + b.abs())).all()
    for a, b in zip(outs["cuda"][2:], outs["cpu"][2:]):
        assert ((a - b).abs() <= 1e-4 * (1 + b.abs().max())).all()


@pytest.mark.cuda
def test_moe_engine_graph_tokens_and_launches_equal_eager():
    """The MoE decode step captured in the engine's graph (sort, cumsum and
    the fp32 dispatch einsums inside it) gives the eager engine's tokens and
    launches, at one capacity row an expert (as the full model decodes)."""
    _require_card()
    import numpy as np

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import MemoryPlan
    from repro_torch.models import kvcache as KV
    from repro_torch.models.model import init_params, num_repeats
    from repro_torch.serve import DecodeEngine, Request, choose_paging

    cfg = _moe_cfg(0.5)
    shape = ShapeConfig("serve", 256, 4, "decode")
    spec = choose_paging(KV.cache_len(cfg, 256), 16, 2)
    n = num_repeats(cfg) + 2
    plan = MemoryPlan(n, num_repeats(cfg), n_persist=n, n_host=spec.n_cold)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, int(k)).tolist() for k in (40, 97, 150, 71)]
    runs = {}
    for graphs in (True, False):
        eng = DecodeEngine(cfg, plan, "cuda", shape, params, paging=spec, own_params=True,
                           admission="chunked", prefill_chunk=16, graphs=graphs)
        eng.warmup()
        K.reset_launch_counts()
        rep = eng.run([Request(i, p, 6) for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        assert rep.drained
        runs[graphs] = (rep.finished, K.launch_counts())
    assert runs[True] == runs[False]
    assert runs[True][1]["paged_attention"] > 0 and runs[True][1]["rmsnorm"] > 0


@pytest.mark.cuda
def test_moe_train_step_runs_on_card():
    """Two steps of the reduced bf16 MoE through the training kernels with
    host weights and a checkpointed block: losses finite, the aux loss in
    the loss, flash forward and backward and fused Adam launched (the fp32
    router's leaf too)."""
    _require_card()
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import MemoryPlan
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.train.step_builder import build_train_step

    cfg = _moe_cfg()
    shape = ShapeConfig("card", 256, 2, "train")
    plan = MemoryPlan(4, 2, n_persist=2, n_host=2, n_checkpoint=1, microbatch=2,
                      host_params=True, n_buffer=1)
    art = build_train_step(cfg, plan, "cuda", shape)
    state = art.init(torch.Generator(device="cuda").manual_seed(0))
    router = state["opt"]["master"]["runs"][-1]["pos0"]["moe"]["router"]
    assert router.dtype == torch.float32 and router.is_pinned()
    pipe = SyntheticTokenPipeline(cfg, shape, device="cuda")
    K.reset_launch_counts()
    for _ in range(2):
        state, metrics = art.fn(state, pipe.next_sync())
        loss, ce = float(metrics["loss"]), float(metrics["ce"])
        assert torch.isfinite(metrics["loss"]).item() and loss > ce
    for name in ("flash_attention", "flash_attention_bwd", "fused_adam", "rmsnorm"):
        assert K.launch_counts()[name] > 0, name


# ---------------------------------------------------------------------------
# The Mamba-2 family on the card
# ---------------------------------------------------------------------------
def _mamba_cfg(arch="mamba2-130m", dtype="bfloat16"):
    """Reduced mamba2-130m; for the hybrid, reduced Jamba at the kernels'
    widths: 8 query heads over 1 KV head of 128 (its group)."""
    from repro_torch.configs import get_config, reduced

    if arch == "mamba2-130m":
        return reduced(get_config(arch), dtype=dtype)
    return reduced(get_config(arch), head_dim=128, num_heads=8, num_kv_heads=1, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [512, 300])
def test_ssd_chunked_on_card_matches_cpu(s):
    """``ssd_chunked`` in fp32 on the card against the CPU (no TF32): output,
    final state and every input's gradient within 1e-4 of each tensor's
    largest value; S a multiple of the chunk and not."""
    _require_card()
    from repro_torch.models.mamba2 import ssd_chunked

    assert not torch.backends.cuda.matmul.allow_tf32
    gen = torch.Generator().manual_seed(0)
    b, h, p, n = 2, 4, 32, 64
    inputs = [torch.randn(b, s, h, p, generator=gen), 0.05 + torch.rand(b, s, h, generator=gen),
              -(0.2 + torch.rand(h, generator=gen)), torch.randn(b, s, n, generator=gen),
              torch.randn(b, s, n, generator=gen), torch.randn(b, h, p, n, generator=gen)]
    outs = {}
    for dev in ("cpu", "cuda"):
        leaves = [t.to(dev).requires_grad_() for t in inputs]
        y, st = ssd_chunked(*leaves[:5], 128, leaves[5])
        grads = torch.autograd.grad((y * y).sum() + (st * st).sum(), leaves)
        outs[dev] = [t.detach().cpu() for t in (y, st, *grads)]
    for a, c in zip(outs["cuda"], outs["cpu"]):
        assert ((a - c).abs() <= 1e-4 * c.abs().max()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-1.5-large-398b"])
def test_mamba_engine_graph_tokens_and_launches_equal_eager(arch):
    """The decode step with Mamba-2 positions captured in the engine's graph
    (the state written in place through its SlotWrite) gives the eager
    engine's tokens and launches: mamba2-130m resident under replay
    admission, the hybrid paged under chunked admission."""
    _require_card()
    import numpy as np

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import MemoryPlan
    from repro_torch.models import kvcache as KV
    from repro_torch.models.model import init_params, num_repeats
    from repro_torch.serve import DecodeEngine, Request, choose_paging

    cfg = _mamba_cfg(arch)
    shape = ShapeConfig("serve", 256, 4, "decode")
    n = num_repeats(cfg) + 2
    if cfg.attention_free:
        spec, plan, kw = None, MemoryPlan(n, num_repeats(cfg), n_persist=n), {}
    else:
        spec = choose_paging(KV.cache_len(cfg, 256), 16, 2)
        plan = MemoryPlan(n, num_repeats(cfg), n_persist=n, n_host=spec.n_cold)
        kw = dict(admission="chunked", prefill_chunk=16)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, int(k)).tolist() for k in (40, 97, 150, 71)]
    runs = {}
    for graphs in (True, False):
        eng = DecodeEngine(cfg, plan, "cuda", shape, params, paging=spec, own_params=True,
                           graphs=graphs, **kw)
        eng.warmup()
        K.reset_launch_counts()
        rep = eng.run([Request(i, p, 6) for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        assert rep.drained
        runs[graphs] = (rep.finished, K.launch_counts())
    assert runs[True] == runs[False]
    assert runs[True][1]["rmsnorm"] > 0
    assert (runs[True][1]["paged_attention"] > 0) == (not cfg.attention_free)


@pytest.mark.cuda
def test_mamba_train_step_runs_on_card():
    """Two steps of reduced bf16 mamba2-130m with host weights, a
    checkpointed block and a compress8 one: losses finite, RMSNorm (the
    gated norm too) and fused Adam launched, the fp32 A_log's optimizer
    state pinned."""
    _require_card()
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import MemoryPlan
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.train.step_builder import build_train_step

    cfg = _mamba_cfg()
    shape = ShapeConfig("card", 256, 2, "train")
    plan = MemoryPlan(4, 2, n_persist=2, n_host=2, microbatch=2, host_params=True,
                      n_buffer=1, act_policies=("checkpoint", "compress8"))
    art = build_train_step(cfg, plan, "cuda", shape)
    state = art.init(torch.Generator(device="cuda").manual_seed(0))
    a_log = state["opt"]["master"]["runs"][-1]["pos0"]["mamba"]["A_log"]
    assert a_log.dtype == torch.float32 and a_log.is_pinned()
    pipe = SyntheticTokenPipeline(cfg, shape, device="cuda")
    K.reset_launch_counts()
    for _ in range(2):
        state, metrics = art.fn(state, pipe.next_sync())
        assert torch.isfinite(metrics["loss"]).item()
    for name in ("rmsnorm", "fused_adam", "fused_quantize_ef"):
        assert K.launch_counts()[name] > 0, name
    assert K.launch_counts()["flash_attention"] == 0


# (launcher, argv): the launchers as a user runs them, at full depth
LAUNCHER_CASES = [
    ("train", ["--arch", "mistral-7b", "--steps", "2", "--batch", "1", "--seq", "4096"]),
    ("serve", ["--arch", "mistral-7b", "--plan", "paged"]),
    ("train", ["--arch", "seamless-m4t-large-v2", "--steps", "2", "--batch", "1", "--seq",
               "4096"]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("which,argv", LAUNCHER_CASES,
                         ids=["train_mistral", "serve_mistral", "train_seamless"])
def test_launchers_on_card(which, argv, capsys):
    """``launch.train`` runs its searched plan as searched (host chunks
    pinned, the allocator's segments expandable) to finite losses;
    ``launch.serve`` drains its default request stream on the paged plan."""
    _require_card()
    import json
    import math

    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    before = K.launch_counts()
    rc = {"train": launch_train, "serve": launch_serve}[which].main(argv)
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    after = K.launch_counts()
    assert summary["device"].startswith("cuda")
    if which == "train":
        assert summary["steps"] == 2
        assert math.isfinite(summary["first_loss"]) and math.isfinite(summary["final_loss"])
        for name in ("flash_attention", "flash_attention_bwd", "fused_adam"):
            assert after[name] > before[name], name
    else:
        assert summary["drained"]
        assert after["paged_attention"] > before["paged_attention"]


@pytest.mark.cuda
def test_dryrun_kernel_route_builds_and_launches_nothing():
    """The dry-run's kernel route: a fake CUDA step of reduced llama3-405b
    at world one (fake tensors under ``FakeTensorMode``, the kernels'
    fakes) launches no kernel, counts the flash fakes' FLOPs, and
    allocates nothing on the card once the process has its CUDA context
    (which torch's fake mode makes with one real 4-byte tensor at the
    first fake CUDA tensor, ``init_gpu_context``)."""
    _require_card()
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.hardware import ONE_CHIP
    from repro_torch.core.plan import MemoryPlan
    from repro_torch.launch import dryrun as D
    from repro_torch.models.model import num_repeats

    cfg = reduced(get_config("llama3-405b"))
    n = num_repeats(cfg)
    plan = MemoryPlan(n + 2, n, n_persist=1, n_checkpoint=1, microbatch=4)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before, launches = torch.cuda.memory_allocated(), dict(K.launch_counts())
    got = D.fake_step(cfg, ShapeConfig("t", 256, 8, "train"), plan, ONE_CHIP, "cuda")
    assert K.launch_counts() == launches
    assert torch.cuda.max_memory_allocated() == before
    assert got["kernel_flops"]["flash_attention"] > 0
    assert got["kernel_flops"]["flash_attention_bwd"] > 0
    assert got["memory"]["temp_gb"] > 0 and got["counted_flops"] > 0
