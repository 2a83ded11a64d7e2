"""The kernels on fake tensors: output shapes and dtypes, and FLOPs.

The dry-run (``launch/dryrun.py``) runs a production step once on fake
tensors (``torch._subclasses.fake_tensor.FakeTensorMode``: shapes, dtypes
and storages, no data, no allocation). A fake CUDA tensor takes the kernel
route of ``kernels/__init__``, and there each wrapper calls its fake here
in place of the CUDA kernel: the outputs the kernel allocates, with its
shapes and dtypes, and nothing computed -- never the plain version's
arithmetic, whose temporaries (the whole-row attention's S x S scores)
the kernel does not allocate. The nvcc extension is never loaded. A fake
CPU tensor takes the plain version, as a real one does.

``count_flops`` records what each fake call would compute in the
contractions a FLOP counter sees (``torch.utils.flop_counter``: matmuls,
2 FLOPs a multiply-add; elementwise work counts nothing): the flash
forward's two products over the (query, key) pairs it attends, 4 * B * Hq
* pairs * hd, its backward's five (the scores again, dV, dP, dQ, dK), the
paged kernel's two over the cache rows. RMSNorm, Adam and the quantizer
count nothing. Counts go to every ``counting()`` table open, and to none
outside one.
"""
from __future__ import annotations

import contextlib

import torch

_TABLES: list[dict[str, float]] = []


@contextlib.contextmanager
def counting():
    """A table ``{kernel name: FLOPs}`` that the fake calls made inside the
    block fill."""
    table: dict[str, float] = {}
    _TABLES.append(table)
    try:
        yield table
    finally:
        _TABLES.remove(table)


def count_flops(name: str, flops: float) -> None:
    for table in _TABLES:
        table[name] = table.get(name, 0.0) + float(flops)


def _ramp(a: int, b: int, c: int) -> int:
    """The sum over p in [a, b) of max(0, p + c)."""
    lo = max(a, -c)
    if b <= lo:
        return 0
    return (b - lo) * (lo + c) + (b - lo) * (b - lo - 1) // 2


def _below(sq: int, sk: int, q_offset: int, c: int) -> int:
    """The sum over queries of min(sk, max(0, p + c)), p = i + q_offset:
    the keys j < sk below p + c."""
    a, b = q_offset, q_offset + sq
    full = max(a, min(b, sk - c))  # from here on every key lies below p + c
    return _ramp(a, full, c) + (b - full) * sk


def attended_pairs(sq: int, sk: int, causal: bool, window: int, q_offset: int) -> int:
    """The (query, key) pairs a mask admits: query i (at position p = i +
    q_offset) sees keys j < sk with j <= p when causal and j > p - window
    under a window."""
    upper = _below(sq, sk, q_offset, 1) if causal else sq * sk
    lower = _below(sq, sk, q_offset, 1 - window) if window else 0
    return upper - lower


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    b, sq, hq, hd = q.shape
    pairs = attended_pairs(sq, k.shape[1], causal, window, q_offset)
    count_flops("flash_attention", 4.0 * b * hq * hd * pairs)
    return (torch.empty(b, sq, hq, hd, dtype=q.dtype, device=q.device),
            torch.empty(b, hq, sq, dtype=torch.float32, device=q.device))


def flash_attention_bwd(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    b, sq, hq, hd = q.shape
    pairs = attended_pairs(sq, k.shape[1], causal, window, q_offset)
    count_flops("flash_attention_bwd", 10.0 * b * hq * hd * pairs)
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty(k.shape, dtype=k.dtype, device=q.device),
            torch.empty(v.shape, dtype=v.dtype, device=q.device))


def paged_attention(q, k_cold) -> torch.Tensor:
    b, _, hq, hd = q.shape
    count_flops("paged_attention", 4.0 * b * hq * hd * k_cold.shape[1])
    return torch.empty_like(q)


def fused_quantize_ef(ch: torch.Tensor):
    return (torch.empty(ch.shape, dtype=torch.int8, device=ch.device),
            torch.empty(ch.shape[0], dtype=torch.float32, device=ch.device),
            torch.empty(ch.shape[1:], dtype=torch.float32, device=ch.device))
