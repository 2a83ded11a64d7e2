#!/usr/bin/env python3
"""Time the RMSNorm kernel of two checkouts in turns, on one card.

Each side is a fresh process that builds that checkout's kernels and times
its ``kernels.fused_rmsnorm`` on bf16 rows of 4096 (4 rows: a decode step's
shape; 4096: a training microbatch's) with this checkout's graph-replay
harness (``chip_smoke.time_ms``), beside ``F.rms_norm`` and, where the
checkout has one, the empty-kernel floor and the kernel with programmatic
dependent launch off and on. Order: parent, change, change, parent.

    git archive <parent> | tar -x -C build/parent
    python3 scripts/rmsnorm_chip.py --parent build/parent --change .

Needs one CUDA card and nvcc, as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]

RUN = r"""
import json, pathlib, sys
root, harness = pathlib.Path(sys.argv[1]).resolve(), sys.argv[2]
sys.path[:0] = [str(root / "src"), harness]
import torch
import torch.nn.functional as F
import chip_smoke as cs
from repro_torch import kernels as K
from repro_torch.kernels import ref, rmsnorm as R

gen = torch.Generator(device="cuda").manual_seed(0)
for rows in (4, 4096):
    x = torch.randn(rows, 1, 4096, device="cuda", generator=gen).bfloat16()
    s = (1 + 0.1 * torch.randn(4096, device="cuda", generator=gen)).bfloat16()
    want = ref.rmsnorm_ref(x, s)
    out = K.fused_rmsnorm(x, s)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs()
    assert bool((err <= cs.RMSNORM_TOL * (1 + want.float().abs())).all()), rows
    row = {"rows": rows, "max_abs_err": err.max().item(),
           **cs.timed("ms", lambda: K.fused_rmsnorm(x, s)),
           **cs.timed("library_ms", lambda: F.rms_norm(x, (4096,), weight=s, eps=1e-6))}
    if hasattr(R, "empty_kernel_cuda"):  # a checkout whose kernel takes pdl
        row.update(cs.timed("ms_no_pdl", lambda: R.rmsnorm_cuda(x, s, pdl=False)))
        row.update(cs.timed("ms_pdl", lambda: R.rmsnorm_cuda(x, s, pdl=True)))
    print(json.dumps(row), flush=True)
if hasattr(R, "empty_kernel_cuda"):
    dev = torch.device("cuda")
    print(json.dumps({"empty_kernel": True, **cs.timed("ms", lambda: R.empty_kernel_cuda(dev))}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True)
    ap.add_argument("--change", type=pathlib.Path, required=True)
    args = ap.parse_args()
    roots = {"p": ("parent", args.parent), "c": ("change", args.change)}
    failed = 0
    for side in "pccp":
        label, root = roots[side]
        res = subprocess.run([sys.executable, "-c", RUN, str(root), str(HERE)],
                             capture_output=True, text=True)
        for line in res.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps({"side": label, **json.loads(line)}), flush=True)
        if res.returncode:
            print(f"{label} ({root}) exited {res.returncode}:\n{res.stderr[-4000:]}",
                  file=sys.stderr, flush=True)
            failed = 1
    return failed


if __name__ == "__main__":
    sys.exit(main())
