#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one sm_90 card and nvcc:

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. the kernels' build from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes, with its time, its plain version's, a library
     call's and the card's bound for the same work;
  4. ``DecodeEngine`` at the full width and depth of ``mistral-7b`` (random
     bf16 weights from a seeded generator), serving 4 requests with chunked
     admission on a paged plan whose cold pages sit in pinned host memory;
     both kernels must have been launched by that run, and one teacher-forced
     decode step through the kernels must agree with the plain path (same
     greedy token in every row). The same step is then timed twice: launched
     from Python as the engine launches it (host wall time), and replayed
     from a CUDA graph (the device time of its work alone); one minus their
     ratio bounds from below the share of the step in which the card idles.

Then the kernels summary line, and last the result line. Any failed check
raises: the script exits non-zero and prints no result line. It exits
non-zero at once without CUDA, or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent

# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W)
# and the host link (PCIe 5.0 x16, one direction).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # outside the tensor cores
HOST_LINK_BYTES_PER_S = 64e9

# Kernel vs plain version, bf16 outputs compared in fp32. RMSNorm outputs are of
# order 1: |k - p| <= RMSNORM_TOL * (1 + |p|), the repository's bf16 bound
# (tests/test_kernels.py: atol = rtol = 2e-2). Paged-attention outputs are
# softmax-weighted means of hundreds of rows, of order 0.05, so their bound
# scales with the output: |k - p| <= PAGED_TOL * max |p| over each (batch row,
# head), a few bf16 roundings of that head's output.
RMSNORM_TOL = 2e-2
PAGED_TOL = 2e-2
# Teacher-forced logits, kernels vs the plain path, bf16 through 32 layers:
# |diff| <= ENGINE_TOL * (1 + max |logit|).
ENGINE_TOL = 5e-2

# The serving slice's shapes (mistral-7b: 32 query heads over 8 KV heads, hd 128).
BATCH, HQ, HKV, HD = 4, 32, 8, 128
SEQ_LEN, PAGE, N_HOT = 1024, 256, 2
PREFILL_CHUNK, NEW_TOKENS = 32, 16
PROMPT_LENS = (520, 800)  # past the 2-page hot window: cold pages are read


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _event_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` CUDA-event windows."""
    import torch

    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def time_ms(fn, reps: int = 15, inner: int = 10) -> tuple[float, float]:
    """Per-call time of ``fn`` on the card: (device ms, eager ms).

    Device ms replays ``inner`` calls captured in a CUDA graph, so it is the
    work's time on the card without the host's launch cost; eager ms times
    the same calls launched from Python (what one call costs the caller)."""
    import torch

    def eager():
        for _ in range(inner):
            fn()

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    eager_ms = _event_ms(eager, reps) / inner
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        eager()
    graph.replay()
    torch.cuda.synchronize()
    return _event_ms(graph.replay, reps) / inner, eager_ms


def timed(prefix: str, fn) -> dict:
    device_ms, eager_ms = time_ms(fn)
    return {prefix: device_ms, prefix.replace("ms", "eager_ms"): eager_ms}


def max_excess(out, ref, tol) -> tuple[float, float]:
    """(max |out - ref|, max of |out - ref| - tol) in fp32; ``tol`` is a
    number or a tensor of ref's shape."""
    d = (out.float() - ref.float()).abs()
    return d.max().item(), (d - tol).max().item()


def phase_card() -> str:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("card", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    ptxas = [line for line in build.BUILD_INFO["log"].splitlines() if "Used" in line]
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=build.BUILD_INFO["seconds"],
         built=build.BUILD_INFO["built"], lib=build.BUILD_INFO["lib"], ptxas=ptxas)


def rmsnorm_case(rows: int, gen) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import fused_rmsnorm
    from repro_torch.kernels.ref import rmsnorm_ref

    d = 4096
    x = torch.randn(rows, 1, d, device="cuda", generator=gen).bfloat16()
    s = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).bfloat16()
    out = fused_rmsnorm(x, s)
    ref = rmsnorm_ref(x, s)
    torch.cuda.synchronize()
    err, excess = max_excess(out, ref, RMSNORM_TOL * (1 + ref.float().abs()))
    assert excess <= 0, f"rmsnorm rows={rows}: max |diff| {err} beyond tolerance"
    nbytes = 2 * x.numel() * x.element_size() + s.numel() * s.element_size()
    flops = 4 * x.numel()
    bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
    return {
        "rows": rows, "d": d, "max_abs_err": err, "tol": f"{RMSNORM_TOL} * (1 + |plain|)",
        **timed("ms", lambda: fused_rmsnorm(x, s)),
        **timed("plain_ms", lambda: rmsnorm_ref(x, s)),
        **timed("library_ms", lambda: F.rms_norm(x, (d,), weight=s, eps=1e-6)),
        "bound_ms": bound, "bound_bytes": nbytes,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOP_PER_S else "operations",
    }


def paged_inputs(case: str, cold_on_host: bool, gen):
    """The paged kernel's inputs at the serving shapes. ``main`` takes sel
    and mask from ``PagedKV.prepare`` at mid-run positions of mistral-7b's
    ring cache (past the hot window, so cold rows are attended); ``full``
    masks by position without the ring rule; ``ring`` is a wrapped ring
    (every row attendable) with a random 50/50 sel."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import kvcache as KV
    from repro_torch.serve.paging import PagedKV, choose_paging

    b, s, w = BATCH, SEQ_LEN, PAGE * N_HOT
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).bfloat16()  # noqa: E731
    q, kh, vh = rnd(b, 1, HQ, HD), rnd(b, w, HKV, HD), rnd(b, w, HKV, HD)
    kc, vc = rnd(b, s, HKV, HD), rnd(b, s, HKV, HD)
    pos = torch.tensor([530, 610, 700, 815])
    if case == "main":
        spec = choose_paging(s, PAGE, N_HOT)
        cache = {"pos0": {"k_hot": kh[None]}}
        step = PagedKV(spec).prepare(cache, pos, get_config("mistral-7b"), "cuda")
        sel, mask = step.sel, step.mask
    elif case == "full":
        sel = torch.rand(b, s, device="cuda", generator=gen) < 0.5
        mask = KV.decode_mask(pos, s, sliding=False).to("cuda")
    else:
        sel = torch.rand(b, s, device="cuda", generator=gen) < 0.5
        mask = torch.zeros(b, s, device="cuda")
    if cold_on_host:
        kc, vc = kc.cpu().pin_memory(), vc.cpu().pin_memory()
    return q, kh, vh, kc, vc, sel, mask


def paged_bound(args, cold_on_host: bool) -> tuple[float, str, dict]:
    """Least time for this input: the bytes the function must move (q, out,
    sel, mask, and K and V of every attended row from where it lies) and its
    fp32 operations, against HBM, the host link and the fp32 peak."""
    from repro_torch.serve.paging import attended_rows

    q, kh, vh, kc, vc, sel, mask = args
    valid = attended_rows(mask)
    row = 2 * HKV * HD * q.element_size()  # K and V of one cache row, all kv heads
    hot_rows = int((valid & sel).sum())
    cold_rows = int((valid & ~sel).sum())
    hbm = 2 * q.numel() * q.element_size() + sel.numel() + 4 * mask.numel() + hot_rows * row
    host = cold_rows * row if cold_on_host else 0
    if not cold_on_host:
        hbm += cold_rows * row
    flops = (hot_rows + cold_rows) * HQ * HD * 4 + 5 * HQ * SEQ_LEN * BATCH
    times = {"bytes": max(hbm / HBM_BYTES_PER_S, host / HOST_LINK_BYTES_PER_S),
             "operations": flops / FP32_FLOP_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by, {"hbm_bytes": hbm, "host_bytes": host, "flops": flops}


def paged_case(case: str, cold_on_host: bool, gen) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_paged_attention
    from repro_torch.kernels.ref import paged_attention_ref

    args = paged_inputs(case, cold_on_host, gen)
    out = decode_paged_attention(*args, n_hot=N_HOT)
    ref = paged_attention_ref(*args)
    torch.cuda.synchronize()
    tol = PAGED_TOL * ref.float().abs().amax(dim=-1, keepdim=True)  # per (b, head)
    err, excess = max_excess(out, ref, tol)
    assert excess <= 0, (f"paged_attention {case} host={cold_on_host}: max |diff| {err} "
                         f"beyond {PAGED_TOL} * max |plain| of its head")
    bound, by, work = paged_bound(args, cold_on_host)
    # library yardstick: SDPA over the cache gathered beforehand on the device
    q, kh, vh, kc, vc, sel, mask = args
    rows = torch.arange(SEQ_LEN, device="cuda") % kh.shape[1]
    s4 = sel[..., None, None]
    k = torch.where(s4, kh[:, rows], kc.cuda()).transpose(1, 2)
    v = torch.where(s4, vh[:, rows], vc.cuda()).transpose(1, 2)
    qt = q.transpose(1, 2)
    am = mask[:, None, None, :].to(q.dtype)
    lib = lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=am, enable_gqa=True)  # noqa: E731
    return {
        "case": case, "cold": "pinned_host" if cold_on_host else "device",
        "max_abs_err": err, "max_abs_plain": ref.float().abs().max().item(),
        "tol": f"{PAGED_TOL} * max |plain| per (batch, head)", "tol_min": tol.min().item(),
        **timed("ms", lambda: decode_paged_attention(*args, n_hot=N_HOT)),
        **timed("plain_ms", lambda: paged_attention_ref(*args)),
        **timed("library_ms", lib), "bound_ms": bound, "bound_by": by, **work,
    }


def phase_kernels() -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    rms = [rmsnorm_case(rows, gen) for rows in (BATCH, BATCH * 32)]
    for r in rms:
        emit("kernel_vs_plain", kernel="rmsnorm", **r)
    paged = [paged_case(case, host, gen)
             for case in ("main", "full", "ring") for host in (True, False)]
    for p in paged:
        emit("kernel_vs_plain", kernel="paged_attention", **p)
    return {"rmsnorm": rms, "paged_attention": paged}


def _clone_cache(cache: dict) -> dict:
    import torch

    def clone(t):
        if t.device.type == "cpu" and t.is_pinned():
            return torch.empty_like(t, pin_memory=True).copy_(t)
        return t.clone()

    return {pos: {k: clone(v) for k, v in e.items()} for pos, e in cache.items()}


def step_account(params, cache, tokens, pos, cfg, spec, reps: int = 10) -> dict:
    """One decode step through the kernels, timed two ways on the same inputs.

    ``eager_wall_ms``: host wall time of the step launched from Python as the
    engine launches it, per-step indices (``PagedKV.prepare``) included.
    ``graph_device_ms``: the same work replayed from a CUDA graph, so its
    kernels run back to back; the indices are built once before the capture
    (host work and small host-to-device copies). Graph replay leaves gaps of
    its own, so ``1 - graph/eager`` is a lower bound on the share of the eager
    step in which the card waits for the host. The step rewrites the same
    token at the same slot each time, so every run sees the same cache."""
    import torch

    from repro_torch.models import kvcache as KV
    from repro_torch.serve import PagedKV

    def eager():
        KV.decode_step(params, cache, tokens, pos, cfg, kv_io=PagedKV(spec))

    with torch.inference_mode():
        for _ in range(3):
            eager()
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            eager()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        kv = PagedKV(spec)
        prepared = kv.prepare(cache, pos, cfg, tokens.device)
        kv.prepare = lambda *args, **kwargs: prepared
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            KV.decode_step(params, cache, tokens, pos, cfg, kv_io=kv)
        graph.replay()
        torch.cuda.synchronize()
        device_ms = _event_ms(graph.replay, reps)
    wall_ms = statistics.median(walls)
    return {"positions": pos.tolist(), "eager_wall_ms": wall_ms, "graph_device_ms": device_ms,
            "device_idle_share_at_least": 1.0 - device_ms / wall_ms}


def phase_engine() -> dict[str, int]:
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.plan import MemoryPlan
    from repro_torch.models import kvcache as KV
    from repro_torch.models.model import init_params, num_repeats
    from repro_torch.serve import DecodeEngine, PagedKV, Request, choose_paging

    cfg = get_config("mistral-7b")
    shape = ShapeConfig("smoke", SEQ_LEN, BATCH, "decode")
    spec = choose_paging(KV.cache_len(cfg, SEQ_LEN), PAGE, N_HOT)
    assert (spec.page_size, spec.n_pages, spec.n_hot) == (PAGE, SEQ_LEN // PAGE, N_HOT)
    n_chunks = num_repeats(cfg) + 2  # embedding + one per block + head
    plan = MemoryPlan(n_chunks, num_repeats(cfg), n_persist=n_chunks, n_host=spec.n_cold)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tel = obs.Telemetry()  # keeps the tick spans: host wall time per tick
    engine = DecodeEngine(cfg, plan, "cuda", shape, params, paging=spec, own_params=True,
                          admission="chunked", prefill_chunk=PREFILL_CHUNK, telemetry=tel)
    engine.warmup()
    rng = np.random.default_rng(0)
    lens = rng.integers(*PROMPT_LENS, size=BATCH)
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, int(n)).tolist(), NEW_TOKENS)
            for i, n in enumerate(lens)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tel.tracer.events.clear()
    K.reset_launch_counts()
    report = engine.run(reqs)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    assert report.drained, f"engine did not drain: pending {report.pending}"
    assert sorted(report.finished) == list(range(BATCH))
    assert all(len(t) == NEW_TOKENS for t in report.finished.values()), report.finished
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched by the engine run"
    cold = engine.state["cache"]["pos0"]["k_cold"]
    assert cold.device.type == "cpu" and cold.is_pinned(), "cold store must be pinned host"

    # one teacher-forced decode step, kernels vs the plain path, on copies
    # of the served cache at positions whose attended rows reach cold pages
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (BATCH, 1))).cuda()
    pos = torch.tensor([int(n) + NEW_TOKENS - 1 for n in lens])
    outs = {}
    for use_kernel in (True, False):
        cache = _clone_cache(engine.state["cache"])
        with torch.inference_mode():
            logits, _ = KV.decode_step(engine.state["params"], cache, tokens, pos, cfg,
                                       kv_io=PagedKV(spec, use_kernel=use_kernel))
        outs[use_kernel] = logits.float()
    err = (outs[True] - outs[False]).abs().max().item()
    scale = outs[False].abs().max().item()
    agree = (outs[True].argmax(-1) == outs[False].argmax(-1)).float().mean().item()
    # the served cache itself (the run is over): the step writes position
    # lens + 16 - 1, which no request reached
    account = step_account(engine.state["params"], engine.state["cache"], tokens, pos, cfg, spec)
    ticks = {}
    for name in ("serve.prefill_tick", "serve.decode_tick"):
        durs = [e["dur_s"] for e in tel.tracer.events if e["name"] == name]
        ticks[name] = {"n": len(durs), "median_s": statistics.median(durs) if durs else None,
                       "total_s": sum(durs)}
    emit("engine", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         params=cfg.param_count(), init_s=init_s, paging=[spec.page_size, spec.n_pages, spec.n_hot],
         prompt_lens=[int(n) for n in lens], launches=launches, **report.to_dict(),
         hbm_cache_bytes=report.hbm_cache_bytes, host_cache_bytes=report.host_cache_bytes,
         peak_device_bytes=torch.cuda.max_memory_allocated(), ticks=ticks,
         h2d_bytes=tel.registry.snapshot()["serve.h2d_bytes"]["value"],
         teacher_forced={"max_abs_diff": err, "max_abs_logit": scale,
                         "tol": ENGINE_TOL * (1 + scale), "argmax_agree": agree},
         decode_step=account)
    assert err <= ENGINE_TOL * (1 + scale), (
        f"teacher-forced logits: kernels vs plain differ by {err} (max |logit| {scale})")
    assert agree == 1.0, f"teacher-forced greedy tokens differ in {1 - agree:.0%} of rows"
    return launches


def main() -> int:
    if not (HERE / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: run it from the root of a checkout (no src/repro_torch "
              "beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    phase_card()
    phase_build()
    measured = phase_kernels()
    launches = phase_engine()
    rms = measured["rmsnorm"][0]  # rows = batch: the decode path's shape
    main_case = next(p for p in measured["paged_attention"]
                     if p["case"] == "main" and p["cold"] == "pinned_host")
    paged_err = max(p["max_abs_err"] for p in measured["paged_attention"])
    rms_err = max(r["max_abs_err"] for r in measured["rmsnorm"])
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")  # device times
    summary = {"kernels": [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:91",
         "launches": launches["paged_attention"], "max_abs_err": paged_err,
         **{k: main_case[k] for k in keys}},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:22",
         "launches": launches["rmsnorm"], "max_abs_err": rms_err,
         **{k: rms[k] for k in keys}},
    ]}
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
