"""Wrapper of the CUDA fused-Adam kernel (``csrc/fused_adam.cu``).

Replaces the Pallas ``src/repro/kernels/fused_adam.py::fused_adam``. The
update runs in place: p, master, m and v are overwritten. g (bf16 or fp32)
lies on a CUDA device, the one the kernel runs on; p (bf16 or fp32) and the
fp32 master, m and v lie there too or in pinned host memory (a host chunk's
weights under ``host_params=True``, its optimizer states). Anything else
raises: the kernels package sends CPU gradients to ``ref.fused_adam_ref``
instead.

The kernel only ever reads and writes device memory. A leaf with a tensor
in pinned memory goes through a copy-engine pipeline: it is cut into
``segments`` of ``SEGMENT`` elements, and each segment's pinned tensors pass
through one slot of a ring of ``SLOTS`` device staging buffers that this
module owns (one ring per device, allocated once). Per segment a
host-to-device side stream waits until the slot is free and copies the
pinned master, m and v into it; the current stream waits for that copy and
runs the kernel on the slot (a device p is written where it lies, a pinned
p into the slot); a device-to-host side stream waits for the kernel, copies
the slot back into the pinned tensors and frees the slot. So the copy in of
segment i + 1, the kernel on i and the copy out of i - 1 overlap, the link
moving 12 bytes an element each way (14 out with a pinned bf16 p); how fast
it moves both directions at once depends on the machine (PERF.md). Small
segments shorten the pipeline's fill and drain, large ones the host work
of its Python and launches. The copies in wait for the work queued before
the call (the clipped gradients, the last writers of the states); before
the call returns the current stream waits for the last copy out, so what
is queued after it (the next step's fetch of host weights, a checkpoint)
sees the update.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

SEGMENT = 1 << 20  # elements a segment (4 MiB of each fp32 state)
SLOTS = 3


def segments(n: int, seg: int = SEGMENT) -> list[tuple[int, int]]:
    """(start, length) of the consecutive pieces of ``seg`` elements that
    cover ``n`` elements, the last one shorter. ``seg`` is a multiple of 8,
    so every start keeps fp32 and bf16 pointers 16-byte aligned."""
    if seg <= 0 or seg % 8:
        raise ValueError(f"segment length must be a positive multiple of 8, got {seg}")
    return [(start, min(seg, n - start)) for start in range(0, n, seg)]


class _Ring:
    """``SLOTS`` device staging slots of ``SEGMENT`` elements (master, m, v
    and a p of up to 4 bytes an element), the two copy streams, and for each
    slot the event that its last copy out recorded."""

    def __init__(self, device: torch.device):
        self.slots = torch.empty(SLOTS, 4, SEGMENT, dtype=torch.float32, device=device)
        self.h2d = torch.cuda.Stream(device)
        self.d2h = torch.cuda.Stream(device)
        self.freed: list[torch.cuda.Event | None] = [None] * SLOTS
        self.next = 0


_RINGS: dict[torch.device, _Ring] = {}


def staging_bytes(device) -> int:
    """Device bytes of the staging ring of ``device`` (0 before its first
    pinned update)."""
    ring = _RINGS.get(torch.device(device))
    return 0 if ring is None else ring.slots.numel() * ring.slots.element_size()


def _ring(device: torch.device) -> _Ring:
    ring = _RINGS.get(device)
    if ring is None:
        ring = _RINGS[device] = _Ring(device)
    return ring


def _launch(lib, p, g, master, m, v, scalars, n: int) -> None:
    rc = lib.repro_fused_adam(p.data_ptr(), g.data_ptr(), master.data_ptr(), m.data_ptr(),
                              v.data_ptr(), scalars.data_ptr(), n, build.DTYPE_CODES[p.dtype],
                              build.DTYPE_CODES[g.dtype], build.stream_handle(g.device))
    build.check(lib, rc, "fused_adam launch")
    build.count_launch("fused_adam")


def _pipelined(lib, p, g, master, m, v, scalars) -> None:
    """The update of a leaf with pinned tensors, segment by segment through
    the device's staging ring (see the module docstring)."""
    dev = g.device
    ring = _ring(dev)
    cur = torch.cuda.current_stream(dev)
    ring.h2d.wait_stream(cur)
    flat = [t.view(-1) for t in (p, g, master, m, v)]
    for start, n in segments(p.numel(), SEGMENT):
        slot = ring.next
        ring.next = (slot + 1) % SLOTS
        args = [t[start:start + n] for t in flat]  # p, g, master, m, v
        ins, outs = [], []  # (pinned piece, its staging buffer)
        for j, buf in ((0, ring.slots[slot, 3].view(p.dtype)[:n]), (2, ring.slots[slot, 0, :n]),
                       (3, ring.slots[slot, 1, :n]), (4, ring.slots[slot, 2, :n])):
            if args[j].device.type == "cpu":
                outs.append((args[j], buf))
                if j:  # p is written, never read
                    ins.append((args[j], buf))
                args[j] = buf
        with torch.cuda.stream(ring.h2d):
            if ring.freed[slot] is not None:
                ring.h2d.wait_event(ring.freed[slot])
            for host, buf in ins:
                buf.copy_(host, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(ring.h2d)
        cur.wait_event(ready)
        _launch(lib, *args, scalars, n)
        done = torch.cuda.Event()
        done.record(cur)
        with torch.cuda.stream(ring.d2h):
            ring.d2h.wait_event(done)
            for host, buf in outs:
                host.copy_(buf, non_blocking=True)
            ring.freed[slot] = torch.cuda.Event()
            ring.freed[slot].record(ring.d2h)
    cur.wait_stream(ring.d2h)


def fused_adam_cuda(p, g, master, m, v, scalars):
    """One in-place Adam step of a leaf. ``scalars``: (8,) fp32 on g's device,
    ``[lr, b1, b2, eps, wd, bc1, bc2, 0]``. Returns (p, master, m, v)."""
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"fused-Adam kernel needs g on CUDA, got {dev}")
    for name, t, dtypes in (("p", p, build.DTYPE_CODES), ("g", g, build.DTYPE_CODES),
                            ("master", master, (torch.float32,)), ("m", m, (torch.float32,)),
                            ("v", v, (torch.float32,))):
        if t.dtype not in dtypes:
            raise TypeError(f"fused-Adam kernel: {name} dtype {t.dtype} not in {tuple(dtypes)}")
        if t.shape != p.shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused-Adam kernel: {name} must be contiguous, 16-byte aligned "
                             f"and of p's shape {tuple(p.shape)}, got {tuple(t.shape)}")
    for name, t in (("p", p), ("master", master), ("m", m), ("v", v)):
        if t.device != dev and not (t.device.type == "cpu" and t.is_pinned()):
            raise ValueError(f"fused-Adam kernel: {name} must lie on {dev} or in pinned host "
                             f"memory, got {t.device} (pinned={t.is_pinned()})")
    if scalars.device != dev or scalars.dtype != torch.float32 or tuple(scalars.shape) != (8,):
        raise ValueError(f"fused-Adam kernel: scalars must be (8,) fp32 on {dev}, got "
                         f"{tuple(scalars.shape)} {scalars.dtype} on {scalars.device}")
    if p.numel() == 0:
        return p, master, m, v
    lib = build.load_library()
    if all(t.device == dev for t in (p, master, m, v)):
        _launch(lib, p, g, master, m, v, scalars, p.numel())
    else:
        _pipelined(lib, p, g, master, m, v, scalars)
    return p, master, m, v
