"""The port's Mamba-2 family against the JAX package's, on the CPU.

Reduced ``mamba2-130m`` (2 layers, d 128, 8 SSD heads of 32, d_state 16,
chunk 32, vocab 512): inputs from seeded numpy, parameters from one JAX init
carried across bit for bit by ``repro_torch.models.convert`` (the fp32
``A_log``, ``D`` and ``dt_bias`` beside the bf16 leaves). Tolerances:

* ``ssd_chunked`` and ``apply_mamba2``: outputs within ``1e-5 * (1 +
  |jax|)`` in fp32 (fp32 sums in another order) and ``2e-2 * (1 + |jax|)``
  in bf16 (the in-projection and the conv round to bf16 in each
  framework's order; ``apply_mamba2``'s output within ``2e-2 * (1 + max
  |jax| of its row)``, since the gated RMSNorm scales a row's rounding
  noise with the row: measured 4 bf16 ulps at 1.0), final and conv states
  likewise; gradients of every input and leaf within ``1e-5 * (1 + max
  |jax|)`` of each tensor in fp32; S a multiple of the chunk and not, with
  and without an initial state;
* one decode step continuing a chunked forward's state gives the chunked
  forward's next output within ``1e-5 * (1 + |out|)`` (fp32), and the
  decode path (``kvcache.decode_step``) the JAX decode's logits and states
  within ``1e-5 * (1 + |jax|)``;
* the model's hidden states within ``1e-5 * (1 + |jax|)``, the gradients of
  every block leaf within ``1e-4 * (1 + max |jax|)`` (two layers of fp32
  sums in another order);
* two training steps against the JAX step (fp32) under ``none``,
  ``checkpoint`` (2 microbatches), ``compress8``, ``swap`` and host-weight
  plans: losses and gradient norms within ``1e-4 * (1 + |jax|)``, each
  leaf's Adam update within ``UPDATE_TOL`` in relative L2 (a quantizing
  plan's looser bound, as in tests/test_torch_policies.py). Both steps run
  Adam with eps ``ADAM_EPS`` = 1e-6: at the default 1e-8 an element whose
  gradient is rounding noise (one embedding element here, gradient 1e-8
  against 1e-3 elsewhere) takes a whole step of either sign;
* ``DecodeEngine`` tokens equal to the JAX engine's under replay admission
  (the default for an attention-free config), and a re-admitted slot
  starts from zero conv and ssm state;
* the profiler's matmul FLOPs of a Mamba-2 block exactly the reference's,
  reduced and at full width (B 1, S 32,768: fake tensors), and the search's
  plan equal to the reference's on a shared profile.
"""
import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import ShapeConfig as JShape
from repro.core import autotuner as JA
from repro.core import cost_model as JCM
from repro.core import hardware as JH
from repro.core import profiler as JP
from repro.core.plan import MemoryPlan as JPlan
from repro.data.pipeline import SyntheticTokenPipeline as JPipe
from repro.launch.mesh import make_local_mesh
from repro.models import kvcache as JKV
from repro.models import layers as JL
from repro.models import mamba2 as JM2
from repro.models import model as JM
from repro.optim.adam import AdamConfig as JAdam
from repro.serve import DecodeEngine as JEngine
from repro.serve import Request as JRequest
from repro.train.step_builder import build_train_step as j_build
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import autotuner as TA
from repro_torch.core import cost_model as TCM
from repro_torch.core import hardware as TH
from repro_torch.core import profiler as TP
from repro_torch.core.plan import MemoryPlan
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.models import kvcache as TKV
from repro_torch.models import mamba2 as TM2
from repro_torch.models import model as TM
from repro_torch.optim.adam import AdamConfig, tree_leaves
from repro_torch.serve import DecodeEngine, Request
from repro_torch.train.step_builder import build_train_step

import torch_cores

torch_cores.share_cores()

ARCH = "mamba2-130m"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
STEP_TOL = 1e-4
UPDATE_TOL = {True: 1e-1, False: 1e-3}
LR = 3e-3
ADAM_EPS = 1e-6


def _cfgs(dtype="float32", arch=ARCH):
    jc, tc = jreduced(jget_config(arch), dtype=dtype), reduced(get_config(arch), dtype=dtype)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _excess(out, ref, tol, scale=None) -> float:
    """Largest |out - ref| beyond ``tol * (1 + scale)`` (<= 0 passes);
    ``scale`` defaults to |ref| elementwise."""
    a, b = _np(out), _np(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.abs(b) if scale is None else scale
    return float((np.abs(a - b) - tol * (1.0 + scale)).max())


def _leaf_excess(got, want, tol) -> float:
    return _excess(got, want, tol, float(np.abs(_np(want)).max()))


# ---------------------------------------------------------------------------
# The mixer: ssd_chunked, apply_mamba2
# ---------------------------------------------------------------------------
def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal((b, s, h, p)).astype(np.float32),
                dt=(0.05 + rng.random((b, s, h))).astype(np.float32),
                a=-(0.2 + rng.random(h)).astype(np.float32),
                b_mat=rng.standard_normal((b, s, n)).astype(np.float32),
                c_mat=rng.standard_normal((b, s, n)).astype(np.float32),
                init=0.5 * rng.standard_normal((b, h, p, n)).astype(np.float32))


# (S, with an initial state): S a multiple of the chunk (3 chunks of 16),
# S not one (40: padded to 48), S below one chunk (q = S)
SSD_CASES = [(48, False), (40, True), (11, True)]


@pytest.mark.parametrize("s,init", SSD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_jax(dtype, s, init):
    inp = _ssd_inputs(0, 2, s, 4, 8, 16)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jy, jst = JM2.ssd_chunked(jnp.asarray(inp["x"]).astype(jdt), jnp.asarray(inp["dt"]),
                              jnp.asarray(inp["a"]), jnp.asarray(inp["b_mat"]).astype(jdt),
                              jnp.asarray(inp["c_mat"]).astype(jdt), 16,
                              jnp.asarray(inp["init"]) if init else None)
    ty, tst = TM2.ssd_chunked(torch.from_numpy(inp["x"]).to(tdt), torch.from_numpy(inp["dt"]),
                              torch.from_numpy(inp["a"]), torch.from_numpy(inp["b_mat"]).to(tdt),
                              torch.from_numpy(inp["c_mat"]).to(tdt), 16,
                              torch.from_numpy(inp["init"]) if init else None)
    assert ty.dtype == tdt and tst.dtype == torch.float32
    assert _excess(ty, jy, TOL[dtype]) <= 0
    # the state sums the chunk's inputs in fp32 from equal (bf16) inputs
    assert _excess(tst, jst, TOL["float32"]) <= 0


@pytest.mark.parametrize("s,init", SSD_CASES)
def test_ssd_chunked_gradients_match_jax(s, init):
    """Gradients of <y, ct> + <state, cs> with respect to every input, the
    initial state among them, against ``jax.grad`` (fp32)."""
    inp = _ssd_inputs(1, 2, s, 4, 8, 16)
    names = ["x", "dt", "a", "b_mat", "c_mat"] + (["init"] if init else [])
    rng = np.random.default_rng(2)
    ct = rng.standard_normal((2, s, 4, 8)).astype(np.float32)
    cs = rng.standard_normal((2, 4, 8, 16)).astype(np.float32)

    def jobj(*args):
        kw = dict(zip(names, args))
        y, st = JM2.ssd_chunked(kw["x"], kw["dt"], kw["a"], kw["b_mat"], kw["c_mat"], 16,
                                kw.get("init"))
        return jnp.sum(y * ct) + jnp.sum(st * cs)

    jg = jax.grad(jobj, argnums=tuple(range(len(names))))(*[jnp.asarray(inp[k]) for k in names])
    leaves = [torch.from_numpy(inp[k]).requires_grad_() for k in names]
    kw = dict(zip(names, leaves))
    y, st = TM2.ssd_chunked(kw["x"], kw["dt"], kw["a"], kw["b_mat"], kw["c_mat"], 16,
                            kw.get("init"))
    tg = torch.autograd.grad((y * torch.from_numpy(ct)).sum() + (st * torch.from_numpy(cs)).sum(),
                             leaves)
    for name, g, want in zip(names, tg, jg):
        assert _leaf_excess(g, want, TOL["float32"]) <= 0, name


def _mixer_params(jc, seed=0):
    """One Mamba-2 mixer's JAX parameters (fp32 A_log, D, dt_bias with
    values off their init, the rest in the config's dtype) and the port's
    copy."""
    jp = JL.init_tree(JM2.mamba2_defs(jc), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 10)
    fp32 = ("A_log", "D", "dt_bias")
    jp = {k: (jnp.asarray(0.5 * rng.standard_normal(v.shape).astype(np.float32)) + (k != "dt_bias")
              if k in fp32 else v.astype(jnp.dtype(jc.dtype))) for k, v in jp.items()}
    jp["conv_b"] = jnp.asarray(0.1 * rng.standard_normal(jp["conv_b"].shape)).astype(
        jnp.dtype(jc.dtype))
    return jp, convert.tree_from_numpy(jax.device_get(jp))


@pytest.mark.parametrize("s,init", [(64, False), (45, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba2_matches_jax(dtype, s, init):
    jc, tc = _cfgs(dtype)
    jp, tp = _mixer_params(jc)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    d_in, h, conv_dim = JM2.mamba2_dims(jc)
    mc = jc.mamba2
    conv0 = rng.standard_normal((2, mc.d_conv - 1, conv_dim)).astype(np.float32)
    ssm0 = 0.3 * rng.standard_normal((2, h, mc.head_dim, mc.d_state)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jstate = (jnp.asarray(conv0).astype(jdt), jnp.asarray(ssm0)) if init else None
    tstate = (torch.from_numpy(conv0).to(tdt), torch.from_numpy(ssm0)) if init else None
    jout, (jconv, jssm) = JM2.apply_mamba2(jp, jnp.asarray(x).astype(jdt), jc, state=jstate,
                                           return_state=True)
    out, (conv, ssm) = TM2.apply_mamba2(tp, torch.from_numpy(x).to(tdt), tc, state=tstate,
                                        return_state=True)
    assert out.dtype == tdt and conv.dtype == tdt and ssm.dtype == torch.float32
    # per row: the gated RMSNorm scales each row's rounding noise with the row
    assert _excess(out, jout, TOL[dtype], np.abs(_np(jout)).max(-1, keepdims=True)) <= 0
    assert _excess(ssm, jssm, TOL[dtype]) <= 0
    # the conv state: the last inputs to the conv, the projection's rows
    assert _excess(conv, jconv, TOL[dtype]) <= 0


def test_apply_mamba2_gradients_match_jax():
    jc, tc = _cfgs("float32")
    jp, tp = _mixer_params(jc, seed=4)
    x = np.random.default_rng(5).standard_normal((2, 40, jc.d_model)).astype(np.float32)
    ct = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def jobj(p, xx):
        return jnp.sum(JM2.apply_mamba2(p, xx, jc) * ct)

    jgp, jgx = jax.grad(jobj, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = TM2.apply_mamba2(leaves, tx, tc)
    names = sorted(leaves)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                [tx] + [leaves[k] for k in names])
    for name, g, want in zip(["x"] + names, grads, [jgx] + [jgp[k] for k in names]):
        assert _leaf_excess(g, want, TOL["float32"]) <= 0, name


def test_decode_step_continues_the_chunked_state():
    """The recurrence one token at a time, from the state a chunked forward
    of S tokens returns, gives the chunked forward's output at S + 1 (fp32)."""
    jc, tc = _cfgs("float32")
    _, tp = _mixer_params(jc, seed=7)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 70, 128)).astype(np.float32))
    full = TM2.apply_mamba2(tp, x, tc)
    _, state = TM2.apply_mamba2(tp, x[:, :67], tc, return_state=True)
    for t in range(67, 70):
        out, state = TM2.apply_mamba2(tp, x[:, t:t + 1], tc, state=state, return_state=True)
        assert _excess(out, full[:, t:t + 1], TOL["float32"]) <= 0, t


def test_check_family_admits_mamba_and_hybrid_and_trees_match():
    """``check_family`` no longer raises for the Mamba-2 and hybrid configs;
    the port's parameter trees have the reference's shapes and dtypes, and
    ``convert`` carries the fp32 leaves bit for bit beside the int16 view of
    the bf16 ones."""
    for arch in (ARCH, "jamba-1.5-large-398b"):
        jc, tc = _cfgs("bfloat16", arch)
        TM.check_family(tc)
        TM.check_family(get_config(arch))
        jp = jax.device_get(JM.init_params(jc, jax.random.PRNGKey(0)))
        tp = convert.tree_from_numpy(jp)
        defs = []
        TM.L.map_defs(defs.append, TM.param_defs(tc))
        assert [(d.shape, d.dtype) for d in defs] == [
            (tuple(a.shape), str(a.dtype)) for a in jax.tree_util.tree_leaves(jp)]
        mamba = tp["blocks"]["pos0"]["mamba"]
        for k in ("A_log", "D", "dt_bias"):
            assert mamba[k].dtype == torch.float32
        assert mamba["in_proj"].dtype == torch.bfloat16
        back = dict(jax.tree_util.tree_leaves_with_path(convert.tree_to_numpy(tp)))
        for path, a in jax.tree_util.tree_leaves_with_path(jp):
            b = back[path]
            assert b.dtype == a.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8)), path


# ---------------------------------------------------------------------------
# The model: forward and gradients, decode
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed):
    """The JAX init of ``arch`` (fp32) from ``seed``, drawn once a module:
    the forward, decode and engine cases share it."""
    jc, _ = _cfgs("float32", arch)
    return jax.device_get(JM.init_params(jc, jax.random.PRNGKey(seed)))


def _model(arch, seed=1):
    """(JAX config, port config, JAX params, the port's copy of them); the
    port's tensors are fresh a call, so a case may mark them for autograd."""
    jc, tc = _cfgs("float32", arch)
    jp = _jax_params(arch, seed)
    return jc, tc, jp, convert.tree_from_numpy(jp)


def model_forward_case(arch, seq, h_tol=TOL["float32"]):
    """The layer stack's hidden states (within ``h_tol * (1 + |jax|)``) and
    aux loss, and the gradients of mean(h^2) + aux with respect to every
    block leaf, against ``repro.models.model.forward`` (fp32)."""
    jc, tc, jp, tp = _model(arch)
    tokens = np.random.default_rng(8).integers(0, jc.vocab_size, (2, seq))

    def jobj(p):
        h, aux = JM.forward(p, {"tokens": jnp.asarray(tokens)}, jc)
        return jnp.mean(h ** 2) + aux, (h, aux)

    (_, (jh, jaux)), jg = jax.jit(jax.value_and_grad(jobj, has_aux=True))(jp)
    leaves = [t.requires_grad_() for t in tree_leaves(tp["blocks"])]
    h, aux = TM.forward(tp, {"tokens": torch.from_numpy(tokens)}, tc)
    grads = torch.autograd.grad((h ** 2).mean() + aux, leaves)
    assert _excess(h, jh, h_tol) <= 0
    assert abs(float(torch.as_tensor(aux).detach()) - float(jaux)) <= 1e-6
    for g, want in zip(grads, jax.tree_util.tree_leaves(jg["blocks"])):
        assert _leaf_excess(g, want, 1e-4) <= 0


def test_mamba_forward_and_gradients_match_jax():
    model_forward_case(ARCH, 80)


def model_decode_case(arch, steps=12, b=2, s=16):
    """``kvcache.decode_step`` token by token against the JAX decode, with
    some slots inactive at some steps: logits and every cache leaf."""
    jc, tc, jp, tp = _model(arch)
    jcache, tcache = JKV.init_cache(jc, b, s), TKV.init_cache(tc, b, s)
    assert {p: {k: tuple(v.shape) for k, v in e.items()} for p, e in tcache.items()} == {
        p: {k: tuple(v.shape) for k, v in e.items()} for p, e in jcache.items()}
    toks = np.random.default_rng(9).integers(0, jc.vocab_size, (b, steps))
    for t in range(steps):
        tok, pos = toks[:, t:t + 1], np.full((b,), t)
        active = np.array([True, t % 3 != 1])
        jl, jcache = JKV.decode_step(jp, jcache, jnp.asarray(tok), jnp.asarray(pos), jc,
                                     active=jnp.asarray(active))
        tl, _ = TKV.decode_step(tp, tcache, torch.from_numpy(tok), torch.from_numpy(pos), tc,
                                active=torch.from_numpy(active))
        assert _excess(tl, jl, TOL["float32"]) <= 0, t
    for p, entry in tcache.items():
        for k, leaf in entry.items():
            assert leaf.dtype == TM.L.torch_dtype(str(jcache[p][k].dtype)), (p, k)
            assert _excess(leaf, jcache[p][k], TOL["float32"]) <= 0, (p, k)


def test_mamba_decode_matches_jax():
    model_decode_case(ARCH)


# ---------------------------------------------------------------------------
# Training steps against the JAX step
# ---------------------------------------------------------------------------
SHAPE, JSHAPE = ShapeConfig("tiny", 40, 4, "train"), JShape("tiny", 40, 4, "train")
PLANS = {  # name: (plan keywords, quantizes)
    "none": (dict(n_persist=4), False),
    "checkpoint_2mb": (dict(n_persist=4, n_checkpoint=2, microbatch=2), False),
    "compress8": (dict(n_persist=4, act_policies=("compress8", "compress8")), True),
    "swap": (dict(n_persist=4, n_swap=2), False),
    "host_weights": (dict(n_persist=2, n_host=2, host_params=True, n_buffer=1), False),
}


def jax_steps(jc, n_chunks, n_blocks, plan_kw, steps=2):
    mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    art = j_build(jc, JPlan(n_chunks, n_blocks, **plan_kw), mesh, JSHAPE, adam=JAdam(lr=LR, eps=ADAM_EPS))
    state = art.init(jax.random.PRNGKey(0))
    init = jax.device_get(state)
    fn = jax.jit(art.fn)
    pipe = JPipe(jc, JSHAPE, seed=0)
    metrics = []
    for _ in range(steps):
        state, m = fn(state, pipe.next_sync())
        metrics.append({k: float(m[k]) for k in ("loss", "ce", "grad_norm")})
    return init, jax.device_get(state), metrics


def train_case(arch, n_chunks, n_blocks, plan_kw, quantizes, name, later_tol=1e-3,
               update_tol=None):
    """Two steps of the plan against the JAX step: losses and gradient norms
    within ``STEP_TOL``, after the first step of a quantizing plan within
    ``later_tol`` (its int8 values flip where the two frameworks' fp32
    noise crosses a rounding boundary); each leaf's update within
    ``update_tol`` (default ``UPDATE_TOL``) in relative L2."""
    update_tol = UPDATE_TOL[quantizes] if update_tol is None else update_tol
    jc, tc = _cfgs("float32", arch)
    jinit, jfinal, jmetrics = jax_steps(jc, n_chunks, n_blocks, plan_kw)
    plan = MemoryPlan(n_chunks, n_blocks, **plan_kw)
    art = build_train_step(tc, plan, "cpu", SHAPE, adam=AdamConfig(lr=LR, eps=ADAM_EPS))
    state = art.place_state(convert.tree_from_numpy(jinit["params"]))
    pipe = SyntheticTokenPipeline(tc, SHAPE, seed=0)
    metrics = []
    for _ in range(2):
        state, m = art.fn(state, pipe.next_sync())
        metrics.append({k: float(m[k]) for k in ("loss", "ce", "grad_norm")})
    for step, (got, want) in enumerate(zip(metrics, jmetrics)):
        assert all(math.isfinite(v) for v in got.values()), got
        tol = STEP_TOL if step == 0 or not quantizes else later_tol
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - want[k]) <= tol * (1 + abs(want[k])), (step, k, got, want)
    init = tree_leaves(convert.tree_from_numpy(jinit["opt"]["master"]))
    want = tree_leaves(convert.tree_from_numpy(jfinal["opt"]["master"]))
    got = tree_leaves(state["opt"]["master"])
    assert len(got) == len(want) == len(init)
    for a, b, i in zip(got, want, init):
        rel = float((a - b).norm() / max(float((b - i).norm()), 1e-30))
        assert rel <= update_tol, f"{name}: an update {rel} from JAX's"


@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_mamba_train_steps_match_jax(plan_name):
    plan_kw, quantizes = PLANS[plan_name]
    train_case(ARCH, 4, 2, plan_kw, quantizes, plan_name)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
B, S = 4, 32


def prompts(vocab=512):
    rng = np.random.default_rng(5)
    return [(i, rng.integers(1, vocab, int(n)).tolist(), 3 + i)
            for i, n in enumerate(rng.integers(3, 13, 4))]


def test_mamba_engine_tokens_match_jax_under_replay():
    jc, tc, jp, tp = _model(ARCH, seed=0)
    shape = ShapeConfig("serve", S, B, "decode")
    jeng = JEngine(jc, JPlan(4, 2, n_persist=4), make_local_mesh(),
                   JShape("serve", S, B, "decode"), jp)
    eng = DecodeEngine(tc, MemoryPlan(4, 2, n_persist=4), "cpu", shape, tp)
    assert eng.admission == jeng.admission == "replay"
    # 6 requests over 4 slots: two are admitted into slots that served others
    reqs = prompts() + [(4, [7, 8, 9, 10], 5), (5, [11, 12], 4)]
    jrep = jeng.run([JRequest(*r) for r in reqs])
    rep = eng.run([Request(*r) for r in reqs])
    assert rep.drained and jrep.drained
    assert rep.finished == jrep.finished
    assert (rep.prefill_ticks, rep.decode_ticks) == (jrep.prefill_ticks, jrep.decode_ticks)
    assert rep.hbm_cache_bytes == rep.resident_cache_bytes > 0 and rep.host_cache_bytes == 0


def test_slot_reset_zeroes_the_recurrent_state():
    """A re-admitted slot starts from zero conv and ssm state (the JAX
    engine's "MUST be reset"): every leaf's rows of the admitted slots are
    zero after admission, the other slots' rows untouched; and a request
    served in a slot after another gives the tokens it gets alone."""
    _, tc, _, tp = _model(ARCH, seed=0)
    shape = ShapeConfig("serve", S, 2, "decode")
    eng = DecodeEngine(tc, MemoryPlan(4, 2, n_persist=4), "cpu", shape, tp)
    eng.run([Request(0, [5, 6, 7, 8], 3), Request(1, [9, 10], 2)])
    cache = eng.state["cache"]
    assert all(float(leaf.abs().sum()) > 0 for e in cache.values() for leaf in e.values())
    before = {(p, k): leaf.clone() for p, e in cache.items() for k, leaf in e.items()}
    eng.submit([Request(2, [3, 4], 2)])
    admitted = eng.scheduler.admit()
    assert admitted == [0]
    from repro_torch.serve.engine import _zero_slots

    _zero_slots(cache, admitted)
    for (p, k), old in before.items():
        assert float(cache[p][k][:, 0].abs().sum()) == 0.0, (p, k)
        assert torch.equal(cache[p][k][:, 1], old[:, 1]), (p, k)
    alone = DecodeEngine(tc, MemoryPlan(4, 2, n_persist=4), "cpu", shape, tp).run(
        [Request(7, [3, 4], 2)])
    again = DecodeEngine(tc, MemoryPlan(4, 2, n_persist=4), "cpu", shape, tp)
    got = again.run([Request(0, [5, 6, 7, 8], 3), Request(1, [9, 10], 2),
                     Request(7, [3, 4], 2)])
    assert got.finished[7] == alone.finished[7]


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------
def jax_trace(cfg, batch, seq):
    defs = JM.param_defs(cfg)["blocks"]
    one = jax.tree.map(lambda d: jax.ShapeDtypeStruct(d.shape[1:], jnp.dtype(d.dtype)), defs,
                       is_leaf=lambda x: hasattr(x, "shape") and not hasattr(x, "aval"))
    x = jax.ShapeDtypeStruct((batch, seq, cfg.d_model), jnp.dtype(cfg.dtype))
    return JP.profile_fn(lambda p, x: JM.apply_superblock(p, x, cfg)[0], one, x,
                         weight_args=(0,))


# reduced at (B 2, S 64) and (B 1, S 70: padded to 3 chunks); full width at
# the mamba_plan shape (B 1, S 32,768), on fake tensors
@pytest.mark.parametrize("red,batch,seq", [(True, 2, 64), (True, 1, 70), (False, 1, 32768)])
def test_mamba_profile_matmul_flops_equal_reference(red, batch, seq):
    jc, tc = jget_config(ARCH), get_config(ARCH)
    if red:
        jc, tc = jreduced(jc), reduced(tc)
    jprof = jax_trace(jc, batch, seq)
    dots = [op.flops for op in jprof.ops if op.name == "dot_general"]
    tprof = TP.trace_superblock(tc, batch, seq)
    assert tprof.matmul_flops == sum(dots)
    jb, tb = JP.profile_superblock(jc, batch, seq), TP.profile_superblock(tc, batch, seq)
    assert tb.boundary_bytes == jb.boundary_bytes
    if not red:
        # in and out projections, norm1's and the gated norm's statistics,
        # and the SSD's 7: 2 x 32768 x (768 x 3352 + 1536 x 768 + 768 +
        # 1536) + the SSD's 226.3 GFLOP
        assert len(dots) == 11
        assert tprof.matmul_flops == 300_463_161_344.0
        # the three products with no contracted axis, 2 FLOPs an output
        # element: (B, nc, Q, Q, H), (B, S, H, P) twice
        n_c = seq // 256
        assert dots.count(2.0 * n_c * 256 * 256 * 24) == 1
        # (the gated norm's statistic, 2 x S x 1536, is the third of that size)
        assert dots.count(2.0 * seq * 24 * 64) == 3
        # the other fields: traffic 8.7 % below (the port's SSD reads C and
        # x where they lie: it copies neither C broadcast over the heads
        # nor a widened x); activation residuals 5.5 % above (the port
        # counts the cumsums' and the mask's inputs, which the reference's
        # opaque jit equations do not)
        assert 0.91 <= tb.hbm_bytes_fwd / jb.hbm_bytes_fwd <= 0.92
        assert 1.0 <= tb.act_residual_bytes / jb.act_residual_bytes <= 1.1
        assert jb.act_residual_bytes == 3_510_288_480  # 3.51 GB a block
        # the reference's numbers chip_smoke.py prints beside the port's
        import importlib.util
        import pathlib

        root = pathlib.Path(__file__).resolve().parents[1]
        spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        assert dataclasses.asdict(jb) == smoke.REFERENCE_MAMBA_PROFILE


# full width at two chunks, and at 1000 tokens (padded to four chunks)
@pytest.mark.parametrize("seq", [512, 1000])
def test_mamba_block_keeps_no_more_than_the_profile_models(seq):
    """What autograd keeps for a full-width block's backward (distinct
    saved storages, weights and input left out;
    ``scripts/saved_bytes_census.py``) is at most the profile's activation
    residuals, which the search budgets: more would let a searched plan run
    out of memory (at 0.983x here; the broadcast C, a permuted and a
    widened copy of x and a second copy of the carries once made it 1.23x)."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("saved_bytes_census",
                                                  root / "scripts" / "saved_bytes_census.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.census(get_config(ARCH), 1, seq)
    assert got["kept_bytes"] <= got["modeled_bytes"], got


def search_pair(arch, seq, batch, red):
    jc, tc = jget_config(arch), get_config(arch)
    if red:
        jc, tc = jreduced(jc), reduced(tc)
    hw_t = TH.H100_SXM if not red else TH.LOCAL_CPU_HW
    hw_j = (JH.HardwareSpec(**dataclasses.asdict(TH.H100_SXM)) if not red
            else JH.LOCAL_CPU_HW)
    jw = JCM.build_workload(jc, JShape("t", seq, batch, "train"), JH.MeshSpec((1,), ("data",)),
                            hw_j)
    tw = TCM.build_workload(tc, ShapeConfig("t", seq, batch, "train"), TH.ONE_CHIP, hw_t)
    assert [dataclasses.asdict(c) for c in tw.chunks] == [dataclasses.asdict(c)
                                                         for c in jw.chunks]
    assert (tw.positions, tw.max_position_param_bytes) == (jw.positions,
                                                           jw.max_position_param_bytes)
    return jw, dataclasses.replace(tw, block=TP.BlockProfile(**dataclasses.asdict(jw.block)))


def same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0) or a == b, (path, a, b)
    else:
        assert a == b, (path, a, b)


def search_case(arch, seq, batch, red):
    jw, tw = search_pair(arch, seq, batch, red)
    jres = JA.search(jw, compress="off", sync="xla")
    tres = TA.search(tw, compress="off", sync="xla")
    same({"plan": dataclasses.asdict(jres.plan), "runtime": vars(jres.runtime),
          "memory": vars(jres.memory), "feasible": jres.feasible},
         {"plan": dataclasses.asdict(tres.plan), "runtime": vars(tres.runtime),
          "memory": vars(tres.memory), "feasible": tres.feasible})
    return tres


@pytest.mark.parametrize("red,seq,batch", [(False, 32768, 1), (True, 64, 2)])
def test_mamba_search_equals_reference_on_shared_profile(red, seq, batch):
    res = search_case(ARCH, seq, batch, red)
    if not red:
        # 24 blocks of 3.51 GB of activations do not fit the card: the plan
        # recomputes blocks
        assert res.feasible and res.plan.block_policies().count("none") < 24


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------
def test_launchers_run_the_reduced_mamba(capsys):
    assert launch_train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
                              "--seq", "40", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])
    assert launch_serve.main(["--arch", ARCH, "--reduced", "--seq-len", "64", "--requests",
                              "2", "--batch-slots", "2", "--max-new", "3", "--prompt-len", "5",
                              "20", "--device", "cpu"]) == 0
    served = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert served["arch"] == ARCH and served["generated_tokens"] == 6
    assert served["admission"] == "replay" and served["plan"] == "resident"
