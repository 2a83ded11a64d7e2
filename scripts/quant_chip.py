#!/usr/bin/env python3
"""Time the fused int8 quantizer of two checkouts in turns, on one card.

Each side is a fresh process that builds that checkout's kernels and runs
its ``kernels.fused_quantize_ef`` on the cases of this checkout's
``chip_smoke.py`` (``QUANT_TRAIN_CASES`` and ``QUANT_MAMBA_CASES``, inputs
from ``quant_inputs``): each result bitwise against the plain version, its
device time (graph replay; eager for the wire's milliseconds), the kernels
one call launches, and the card's byte bound. Order: parent,
change, change, parent.

    git archive <parent> | tar -x -C build/parent
    python3 scripts/quant_chip.py --parent build/parent --change .
    python3 scripts/quant_chip.py --change . --target-loads 2 4 --division-variant

``--target-loads`` / ``--rows-block`` time the change once for each pair of
values of ``kernels/fused_quant.py``'s ``TARGET_LOADS`` and ``ROWS_BLOCK``
(the launch shape ``quant_plan`` picks). ``--division-variant`` times, after
the change, a copy of it (under ``build/quant_reciprocal``) whose quotient
x / scale is a multiply by the rounded reciprocal of scale instead of the
IEEE division: not bitwise (its mismatches are counted), it shows what the
division costs. Needs one CUDA card and nvcc, as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
DIVISION = "rintf(__fdiv_rn(x, scale))"  # csrc/fused_quant.cu quantize

RUN = r"""
import json, pathlib, sys
root, harness = pathlib.Path(sys.argv[1]).resolve(), sys.argv[2]
sweep, bitwise = json.loads(sys.argv[3]), sys.argv[4] == "bitwise"
sys.path[:0] = [str(root / "src"), harness]
import torch
import chip_smoke as cs
from repro_torch import kernels as K
from repro_torch.kernels import build, fused_quant as FQ, ref

build.load_library()
for target, rows_block in sweep:
    if target:
        FQ.TARGET_LOADS, FQ.ROWS_BLOCK = target, rows_block
    gen = torch.Generator(device="cuda").manual_seed(1)
    for case, shape in cs.QUANT_TRAIN_CASES + cs.QUANT_MAMBA_CASES:
        x, me = cs.quant_inputs(case, gen, shape)
        got, want = K.fused_quantize_ef(x, me), ref.fused_quantize_ef_ref(x, me)
        bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
        mismatches = [int((bits(a) != bits(b)).sum()) for a, b in zip(got, want)]
        assert not (bitwise and any(mismatches)), (case, shape, mismatches)
        kernel = lambda: K.fused_quantize_ef(x, me)
        t = {"ms": cs.eager_ms(kernel)} if case == "wire" else cs.timed("ms", kernel)
        z, n = shape
        nbytes = x.numel() * x.element_size() + x.numel() + 4 * z + 4 * n
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
        row = {"case": case, "shape": list(shape), "dtype": str(x.dtype).split(".")[-1], **t,
               "bound_ms": bound, "bound_share": bound / t["ms"], "mismatches": mismatches,
               "kernels_per_call": cs.graph_kernel_nodes(kernel)[0]}
        if hasattr(FQ, "quant_plan"):
            row.update(target_loads=FQ.TARGET_LOADS, rows_block=FQ.ROWS_BLOCK,
                       plan=FQ.quant_plan(z, n, x.dtype).__dict__)
        print(json.dumps(row), flush=True)
        del x, got, want
        torch.cuda.empty_cache()
"""


def run(label: str, root: pathlib.Path, sweep: list, bitwise: bool = True) -> int:
    res = subprocess.run([sys.executable, "-c", RUN, str(root), str(HERE), json.dumps(sweep),
                          "bitwise" if bitwise else "any"], capture_output=True, text=True)
    for line in res.stdout.splitlines():
        if line.startswith("{"):
            print(json.dumps({"side": label, **json.loads(line)}), flush=True)
    if res.returncode:
        print(f"{label} ({root}) exited {res.returncode}:\n{res.stderr[-4000:]}",
              file=sys.stderr, flush=True)
    return res.returncode


def division_variant(change: pathlib.Path) -> pathlib.Path:
    """A copy of the change's package whose quantizer multiplies by the
    reciprocal of the scale in place of the IEEE division."""
    root = change.resolve() / "build" / "quant_reciprocal"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(change / "src" / "repro_torch", root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = root / "src" / "repro_torch" / "kernels" / "csrc" / "fused_quant.cu"
    text = cu.read_text()
    assert text.count(DIVISION) == 1, f"{cu}: no single {DIVISION!r} to replace"
    cu.write_text(text.replace(DIVISION, "rintf(x * (1.f / scale))"))
    return root


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path)
    ap.add_argument("--change", type=pathlib.Path, required=True)
    ap.add_argument("--target-loads", type=int, nargs="*", default=[])
    ap.add_argument("--rows-block", type=int, nargs="*", default=[])
    ap.add_argument("--division-variant", action="store_true")
    args = ap.parse_args()
    failed = 0
    if args.parent is not None:
        roots = {"p": ("parent", args.parent), "c": ("change", args.change)}
        for side in "pccp":
            label, root = roots[side]
            failed |= run(label, root, [[0, 0]])
    sweep = [[t, r] for t in args.target_loads for r in (args.rows_block or [256])]
    if sweep:
        failed |= run("change", args.change, sweep)
    if args.division_variant:
        failed |= run("change", args.change, [[0, 0]])
        failed |= run("reciprocal", division_variant(args.change), [[0, 0]], bitwise=False)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
