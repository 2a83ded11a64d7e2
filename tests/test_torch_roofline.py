"""The dry-run's parts against the reference and against real runs: the
roofline's formulas, the kernels' fakes, the fake step's FLOPs, the CLI.

``launch/roofline.py``'s ``CollectiveOp.wire_bytes`` and ``analyze`` equal
``repro.launch.roofline``'s on the same collective lists (the reference's
``parse_collectives`` handed the list in place of parsing HLO), with the
fp32 correction on and off, to 1e-12 relative.

Each kernel's fake (``kernels/fake.py``), reached through its wrapper on
fake CUDA tensors, returns the plain version's shapes and dtypes on the
same shapes (RMSNorm's forward alone: this CPU build of torch cannot run
autograd on a fake CUDA tensor), launches nothing and counts what
``FlopCounterMode`` counts
over the plain version where both compute the same pairs (no mask): flash
forward and backward, paged attention. ``attended_pairs`` equals a count
by brute force.

The fake step's ``counted_flops`` on the plain route (fake CPU tensors)
equals ``FlopCounterMode`` over the same step on real CPU tensors, for
reduced ``llama3-405b`` and the reduced MoE in fp32 at one and at four
microbatches (the dry-run runs two of them and counts the rest as the
second). The CLI writes an ``ok`` record for ``mamba2-130m`` x
``decode_32k`` on the single-pod mesh and resumes it.
"""
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.core.hardware import TPU_V5E as J_TPU_V5E
from repro.launch import roofline as JRL
from repro_torch import kernels as K
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.hardware import ONE_CHIP, TPU_V5E
from repro_torch.core.plan import MemoryPlan
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.kernels import build, ref
from repro_torch.kernels import fake as FK
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RL
from repro_torch.models.model import num_repeats
from repro_torch.train.step_builder import build_train_step

import torch_cores

torch_cores.share_cores()

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
# (kind, payload bytes, dtype, group size, multiplier)
OPS = [("all-gather", 1 << 20, "bf16", 16, 1.0), ("all-reduce", 3000, "f32", 4, 3.0),
       ("reduce-scatter", 4096, "f32", 32, 1.0), ("all-to-all", 999, "s8", 8, 2.0),
       ("collective-permute", 77, "bf16", 2, 1.0), ("all-gather", 10, "f32", 1, 5.0),
       ("all-reduce", 1 << 30, "bf16", 512, 1.0)]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("op", OPS, ids=[f"{o[0]}-{o[3]}" for o in OPS])
def test_wire_bytes_equal_the_reference(op):
    kind, n, dt, g, m = op
    assert RL.CollectiveOp(kind, n, dt, g, multiplier=m).wire_bytes() == \
        JRL.CollectiveOp(kind, n, dt, g, "step", m).wire_bytes()


@pytest.mark.parametrize("correction", [False, True])
def test_analyze_equals_the_reference(monkeypatch, correction):
    jops = [JRL.CollectiveOp(k, n, dt, g, "step", m) for k, n, dt, g, m in OPS]
    monkeypatch.setattr(JRL, "parse_collectives", lambda hlo: jops)
    kw = dict(flops_per_chip=3.1e15, hbm_bytes_per_chip=7.7e11, model_flops_per_chip=2.9e15)
    want = JRL.analyze(hlo="", hw=J_TPU_V5E, dtype_correction=correction, **kw)
    got = RL.analyze(collectives=[RL.CollectiveOp(k, n, dt, g, multiplier=m)
                                  for k, n, dt, g, m in OPS],
                     hw=TPU_V5E, dtype_correction=correction, **kw)
    for field in ("flops_per_chip", "hbm_bytes_per_chip", "collective_bytes_raw",
                  "collective_bytes_corrected", "t_compute", "t_memory", "t_collective",
                  "model_flops", "useful_flops_ratio"):
        assert _rel(getattr(got, field), getattr(want, field)) <= 1e-12, field
    assert got.bottleneck == want.bottleneck
    assert got.by_kind.keys() == want.by_kind.keys()
    assert all(_rel(got.by_kind[k], want.by_kind[k]) <= 1e-12 for k in want.by_kind)
    assert got.row()["by_kind"] == want.row()["by_kind"]


def test_attended_pairs_equal_a_count():
    def count(sq, sk, causal, window, off):
        i, j = np.arange(sq)[:, None] + off, np.arange(sk)[None, :]
        ok = np.ones((sq, sk), bool)
        if causal:
            ok &= j <= i
        if window:
            ok &= j > i - window
        return int(ok.sum())

    for sq, sk, causal, window, off in itertools.product(
            (1, 5, 16, 33), (1, 7, 16, 40), (True, False), (0, 1, 4, 64), (0, 3, 24)):
        assert FK.attended_pairs(sq, sk, causal, window, off) == \
            count(sq, sk, causal, window, off)


def _plain_flops(fn, *args, **kw) -> float:
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kw)
    return float(fc.get_total_flops())


def _like(ts, device):
    return [torch.empty(t.shape, dtype=t.dtype, device=device) for t in ts]


def _same(got, want):
    got, want = list(got), list(want)
    assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype) for t in want]


def test_kernel_fakes_give_the_plain_shapes_and_flops():
    """Every wrapper on fake CUDA tensors: the plain version's output shapes
    and dtypes, no launch, no library loaded; the FLOPs of the unmasked
    contractions equal ``FlopCounterMode``'s over the plain version."""
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    rnd = lambda *s, dt=bf: torch.randn(*s, generator=g).to(dt)  # noqa: E731
    x, scale = rnd(6, 64), rnd(64)
    q, k, v = rnd(2, 24, 8, 32), rnd(2, 40, 2, 32), rnd(2, 40, 2, 32)
    out, lse = ref.attention_lse_ref(q, k, v, causal=False)
    dq = ref.flash_attention_bwd_ref(q, k, v, out, lse, out, causal=False)
    pq, hot, cold = rnd(3, 1, 8, 32), rnd(3, 4, 2, 32), rnd(3, 12, 2, 32)
    sel, mask = torch.zeros(3, 12, dtype=torch.bool), torch.zeros(3, 12)
    paged = ref.paged_attention_ref(pq, hot, hot, cold, cold, sel, mask)
    p, grad = rnd(5, 7), rnd(5, 7)
    st = [rnd(5, 7, dt=torch.float32) for _ in range(3)]
    adam = ref.fused_adam_ref(p, grad, *st, lr=1e-3, b1=0.9, b2=0.95, eps=1e-8,
                              weight_decay=0.0, bc1=0.1, bc2=0.05)
    ch = rnd(4, 9, 16, dt=torch.float32)
    quant = ref.fused_quantize_ef_ref(ch, 1)
    want_flops = {"flash_attention": _plain_flops(ref.attention_lse_ref, q, k, v, causal=False),
                  "flash_attention_bwd": _plain_flops(ref.flash_attention_bwd_ref, q, k, v, out,
                                                      lse, out, causal=False),
                  "paged_attention": _plain_flops(ref.paged_attention_ref, pq, hot, hot, cold,
                                                  cold, sel, mask)}
    norm = ref.rmsnorm_ref(x, scale)
    launches = dict(K.launch_counts())
    cuda = torch.device("cuda")
    with FakeTensorMode(), FK.counting() as flops:
        fx, fs = _like((x, scale), cuda)
        _same([K.fused_rmsnorm(fx, fs)], [norm])
        fq, fk, fv = _like((q, k, v), cuda)
        fo, fl = K.flash_attention(fq, fk, fv, causal=False)
        _same((fo, fl), (out, lse))
        _same(K.flash_attention_bwd(fq, fk, fv, fo, fl, fo, causal=False), dq)
        fp = _like((pq, hot, hot, cold, cold, sel, mask), cuda)
        _same([K.decode_paged_attention(*fp, n_hot=4)], [paged])
        fa = _like((p, grad, *st), cuda)
        _same(K.fused_adam_update(*fa, torch.empty(8, device=cuda)), adam)
        _same(K.fused_quantize_ef(torch.empty(ch.shape, device=cuda), 1), quant)
    assert flops == want_flops
    assert K.launch_counts() == launches
    assert build._LIB is None


def _dense(model: str):
    arch = {"dense": "llama3-405b", "moe": "qwen2-moe-a2.7b"}[model]
    return reduced(get_config(arch), dtype="float32"), ShapeConfig("tiny", 32, 16, "train")


@pytest.mark.parametrize("model,microbatch", [("dense", 1), ("dense", 4), ("moe", 4)])
def test_fake_step_flops_equal_the_real_steps(model, microbatch):
    """``counted_flops`` of the fake step (plain route, world one) against
    ``FlopCounterMode`` over one real step of the same plan on CPU
    tensors."""
    cfg, shape = _dense(model)
    n = num_repeats(cfg)
    plan = MemoryPlan(n + 2, n, n_persist=n + 2, n_checkpoint=1, microbatch=microbatch)
    built = D.fake_step(cfg, shape, plan, ONE_CHIP, CPU)
    art = build_train_step(cfg, plan, CPU, shape)
    state = art.init(torch.Generator().manual_seed(0))
    batch = SyntheticTokenPipeline(cfg, shape, seed=0).next_sync()
    real = _plain_flops(art.fn, state, batch)
    assert real > 0 and built["counted_flops"] == real
    assert built["collectives"] == [] and built["memory"]["temp_gb"] > 0


def test_cli_writes_an_ok_record_and_resumes(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-130m",
           "--shape", "decode_32k", "--mesh", "single", "--device", "cpu",
           "--out", str(tmp_path)]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    first = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stderr[-2000:]
    assert "complete, 0 failures" in first.stdout
    lines = (tmp_path / D.OUT_NAME).read_text().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["ok"] and rec["mesh"] == "single" and rec["route"] == "plain"
    assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert rec["memory"]["argument_gb"] > 0 and rec["n_collectives"] > 0
    again = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert again.returncode == 0 and "(1 already done)" in again.stdout
    assert len((tmp_path / D.OUT_NAME).read_text().splitlines()) == 1
