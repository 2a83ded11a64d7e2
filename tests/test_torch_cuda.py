"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without an sm_90 card and nvcc. This file imports
only torch and the port, so it runs on a machine without JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Tolerance: bf16 outputs compared in fp32. RMSNorm: ``|k - p| <= 2e-2 * (1 +
|p|)`` (the repository's bf16 bound). Paged attention, whose outputs are
weighted means far below 1: ``|k - p| <= 2e-2 * max |p|`` over each (batch
row, head), a few bf16 roundings of that head's output.
"""
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.compat import cuda_kernel_problems
from repro_torch.kernels import ref

TOL = 2e-2


def _require_card():
    problems = cuda_kernel_problems()
    if problems:
        pytest.skip("needs an sm_90 card and nvcc: " + "; ".join(problems))


def _close(out, want):
    out, want = out.float(), want.float()
    return bool(((out - want).abs() <= TOL * (1 + want.abs())).all())


def _close_to_head_max(out, want):
    out, want = out.float(), want.float()
    return bool(((out - want).abs() <= TOL * want.abs().amax(dim=-1, keepdim=True)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4, 128])
def test_rmsnorm_kernel_matches_plain(rows):
    _require_card()
    g = torch.Generator(device="cuda").manual_seed(rows)
    x = torch.randn(rows, 1, 4096, device="cuda", generator=g).bfloat16()
    s = (1 + 0.1 * torch.randn(4096, device="cuda", generator=g)).bfloat16()
    before = K.launch_counts()["rmsnorm"]
    out = K.fused_rmsnorm(x, s)
    torch.cuda.synchronize()
    assert K.launch_counts()["rmsnorm"] == before + 1
    assert _close(out, ref.rmsnorm_ref(x, s))


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
def test_paged_attention_kernel_refuses_pageable_cold_and_long_rows():
    _require_card()
    q = torch.zeros(1, 1, 4, 128, device="cuda", dtype=torch.bfloat16)
    hot = torch.zeros(1, 64, 1, 128, device="cuda", dtype=torch.bfloat16)
    cold = torch.zeros(1, 128, 1, 128, dtype=torch.bfloat16)  # pageable host memory
    sel = torch.zeros(1, 128, device="cuda", dtype=torch.bool)
    mask = torch.zeros(1, 128, device="cuda")
    with pytest.raises(ValueError, match="pinned"):
        K.decode_paged_attention(q, hot, hot, cold, cold, sel, mask, n_hot=1)
    s = 65536  # a (G, S) fp32 logits row past the 227 KB a block may use
    cold = torch.zeros(1, s, 1, 128, device="cuda", dtype=torch.bfloat16)
    sel = torch.zeros(1, s, device="cuda", dtype=torch.bool)
    mask = torch.zeros(1, s, device="cuda")
    with pytest.raises(ValueError, match="split-KV"):
        K.decode_paged_attention(q, hot, hot, cold, cold, sel, mask, n_hot=1)
