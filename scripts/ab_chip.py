#!/usr/bin/env python3
"""Run phases of ``chip_smoke.py`` from two checkouts in turns, on one card.

Host-bound numbers (a decode step launched from Python, a training step
whose optimizer reads pinned memory over the host link) differ from machine
to machine by more than most changes move them, so a change is compared
with its parent inside one run, in turns: parent, change, change, parent.
Each run is a fresh process that builds that checkout's kernels and runs the
named phases; its JSON phase lines are printed with the checkout's label
(the build phase's line included).

    git archive <parent> | tar -x -C build/parent
    python3 scripts/ab_chip.py --parent build/parent --change . --phases engine train
    python3 scripts/ab_chip.py --parent build/parent --change . \
        --phases train_policies mamba_plan    # phases that take the machine's spec

Needs one CUDA card and nvcc, as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

# p for the parent, c for the change: the ends and the middle see the same
# drift of the machine, so a trend over the run does not read as a change.
ORDER = "pccp"

RUN = r"""
import gc, inspect, pathlib, sys
root = pathlib.Path(sys.argv[1]).resolve()
sys.path[:0] = [str(root), str(root / "src")]
import torch
import chip_smoke
from repro_torch.core.hardware import local_cuda_hw
chip_smoke.phase_build()
hw = None
for name in sys.argv[2:]:
    phase = getattr(chip_smoke, "phase_" + name)
    if inspect.signature(phase).parameters:  # a phase that plans against the machine
        hw = hw or local_cuda_hw()
        phase(hw)
    else:
        phase()
    gc.collect()  # one phase's model goes before the next one's
    torch.cuda.empty_cache()
"""


def run(label: str, root: pathlib.Path, phases: list[str]) -> int:
    res = subprocess.run([sys.executable, "-c", RUN, str(root), *phases], capture_output=True,
                         text=True)
    for line in res.stdout.splitlines():
        if line.startswith("{"):
            print(json.dumps({"side": label, **json.loads(line)}), flush=True)
    if res.returncode:
        print(f"{label} ({root}) exited {res.returncode}:\n{res.stderr[-4000:]}",
              file=sys.stderr, flush=True)
    return res.returncode


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True)
    ap.add_argument("--change", type=pathlib.Path, required=True)
    ap.add_argument("--phases", nargs="+", required=True,
                    help="chip_smoke phase names, e.g. engine train mamba_plan")
    args = ap.parse_args()
    roots = {"p": ("parent", args.parent), "c": ("change", args.change)}
    failed = 0
    for side in ORDER:
        label, root = roots[side]
        failed |= run(label, root, args.phases)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
