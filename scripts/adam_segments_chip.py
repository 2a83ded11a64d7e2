#!/usr/bin/env python3
"""Time the pinned-state fused Adam's copy-engine pipeline at several
segment lengths and ring sizes, beside this machine's host-link rates.

One ``w1`` leaf of mistral-7b (4096 x 14336): fp32 master, m and v in pinned
host memory, the bf16 gradient and p on the device (and, for one setting, p
pinned too). Each setting's update is checked bitwise against the same
kernel on device copies of the same inputs, then timed as ``chip_smoke.py``
times the pinned row (CUDA events, median of 5 windows of 3 calls). The
link's rates, to the device, to the host and both ways at once, come from
``chip_smoke.host_link_rate``: the pipeline moves 12 bytes an element each
way at once, so the both-ways rate is its ceiling. One JSON line a setting.

    python3 scripts/adam_segments_chip.py

Needs one CUDA card and nvcc, as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
# (elements a segment, slots in the ring, p pinned)
SETTINGS = [(1 << 18, 3, False), (1 << 20, 2, False), (1 << 20, 3, False),
            (1 << 22, 3, False), (1 << 24, 2, False), (1 << 20, 3, True)]


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke
    from repro_torch import kernels as K
    from repro_torch.kernels import fused_adam
    from repro_torch.optim.adam import AdamConfig, adam_scalars

    if not torch.cuda.is_available():
        print("adam_segments_chip.py needs a CUDA card", file=sys.stderr)
        return 2
    print(chip_smoke.phase_card(), flush=True)
    link = chip_smoke.host_link_rate()
    print(json.dumps({"host_link": link}), flush=True)
    shape = (4096, 14336)
    n = shape[0] * shape[1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    master = 0.02 * torch.randn(*shape, device="cuda", generator=gen)
    g = (1e-3 * torch.randn(*shape, device="cuda", generator=gen)).bfloat16()
    m = 1e-4 * torch.randn(*shape, device="cuda", generator=gen)
    v = 1e-6 * (0.5 + torch.rand(*shape, device="cuda", generator=gen))
    p = master.bfloat16()
    cfg = AdamConfig(lr=3e-4, weight_decay=0.1)
    scalars = adam_scalars(cfg, cfg.lr, 3, "cuda")
    want = K.fused_adam_update(p.clone(), g, master.clone(), m.clone(), v.clone(), scalars)
    torch.cuda.synchronize()
    host = [torch.empty(shape, pin_memory=True) for _ in range(4)]
    for seg, slots, pinned_p in SETTINGS:
        fused_adam.SEGMENT, fused_adam.SLOTS = seg, slots
        torch.cuda.synchronize()
        fused_adam._RINGS.clear()  # the next call builds a ring of this setting
        torch.cuda.empty_cache()
        for h, t in zip(host, (p.float(), master, m, v)):
            h.copy_(t)
        hp = host[0].bfloat16().pin_memory() if pinned_p else p.clone()
        got = K.fused_adam_update(hp, g, *host[1:], scalars)
        torch.cuda.synchronize()
        bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
        bitwise = all(torch.equal(a.to(b.device).view(bits[a.dtype]), b.view(bits[b.dtype]))
                      for a, b in zip(got, want))
        ms = chip_smoke.eager_ms(lambda: K.fused_adam_update(hp, g, *host[1:], scalars))
        print(json.dumps({
            "segment_elements": seg, "slots": slots, "pinned_p": pinned_p,
            "segments": len(fused_adam.segments(n, seg)), "bitwise": bitwise, "ms": ms,
            "staging_bytes": fused_adam.staging_bytes(g.device),
            "gb_per_s_each_way": 12 * n / ms / 1e6,
            "link_both_ways_gb_per_s_each": link["both_ways_gb_per_s_each"]}), flush=True)
        if not bitwise:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
