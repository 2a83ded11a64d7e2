"""The port's kernels against the JAX package's.

On the CPU the port's kernels package runs the plain versions
(``repro_torch.kernels.ref``); they are held against the JAX oracles
(``repro.kernels.ref``), the Pallas kernels in interpret mode, and the model
path's ``layers.rmsnorm``. Tolerances, as ``atol = rtol`` after casting to
fp32: fp32 1e-4 (XLA and torch sum in different orders), bf16 2e-2 (the bf16
bound of tests/test_kernels.py). The CUDA kernels are held against the same plain
versions on the card in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels import ref as JR
from repro.models import layers as JL
from repro_torch import kernels as K
from repro_torch.kernels import ref as TR

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor, in ``dtype``."""
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(TORCH_DT[dtype])


def _assert_close(out, ref, dtype, what=""):
    a, b = _np32(out), _np32(ref)
    tol = TOL[dtype]
    excess = (np.abs(a - b) - tol * (1.0 + np.abs(b))).max()
    assert excess <= 0.0, f"{what}: max |diff| {np.abs(a - b).max()} beyond {tol}"


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 128), (2, 3, 256)])
def test_rmsnorm_plain_matches_jax(dtype, shape):
    rng = np.random.default_rng(0)
    x_np = rng.standard_normal(shape).astype(np.float32) * 3.0
    s_np = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    xj, xt = _both(x_np, dtype)
    sj, st = _both(s_np, dtype)
    out = TR.rmsnorm_ref(xt, st)
    assert out.dtype == TORCH_DT[dtype] and out.shape == xt.shape
    for name, ref in (("ref.rmsnorm_ref", JR.rmsnorm_ref(xj, sj)),
                      ("ops.rmsnorm (Pallas interpret)", JOPS.rmsnorm(xj, sj)),
                      ("layers.rmsnorm", JL.rmsnorm(xj, sj))):
        _assert_close(out, ref, dtype, name)
    # the CPU dispatch is exactly the plain version
    assert torch.equal(K.fused_rmsnorm(xt, st), out)


# ---------------------------------------------------------------------------
# Paged attention: the sweeps of tests/test_paged_attention_kernel.py:58-82
# ---------------------------------------------------------------------------
def _paged_inputs(seed, b, hq, hkv, s, w, hd, masked_frac=0.2):
    rng = np.random.default_rng(seed)
    f = lambda *shp: rng.standard_normal(shp).astype(np.float32)  # noqa: E731
    q, kh, vh = f(b, 1, hq, hd), f(b, w, hkv, hd), f(b, w, hkv, hd)
    kc, vc = f(b, s, hkv, hd), f(b, s, hkv, hd)
    sel = rng.random((b, s)) < 0.5
    mask = np.where(rng.random((b, s)) < 1.0 - masked_frac, 0.0, -1e30).astype(np.float32)
    return q, kh, vh, kc, vc, sel, mask


def _run_both(arrays, dtype, n_hot):
    q, kh, vh, kc, vc, sel, mask = arrays
    jx = [_both(a, dtype)[0] for a in (q, kh, vh, kc, vc)]
    tx = [_both(a, dtype)[1] for a in (q, kh, vh, kc, vc)]
    jx += [jnp.asarray(sel), jnp.asarray(mask)]
    tx += [torch.from_numpy(sel), torch.from_numpy(mask)]
    out = K.decode_paged_attention(*tx, n_hot=n_hot)
    ref_j = jax.jit(JR.paged_attention_ref)(*jx)
    pallas = JOPS.decode_paged_attention(*jx, n_hot=n_hot)
    return out, ref_j, pallas, tx


SWEEP = [
    (2, 8, 2, 64, 16, 8, 32),    # GQA 4:1, two hot pages
    (1, 4, 4, 32, 8, 8, 16),     # MHA, single hot page
    (3, 6, 3, 48, 24, 8, 64),    # GQA 2:1, three hot pages
    (2, 16, 1, 40, 8, 4, 8),     # MQA, small pages
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,w,psz,hd", SWEEP)
def test_paged_attention_plain_matches_jax(b, hq, hkv, s, w, psz, hd, dtype):
    arrays = _paged_inputs(s + w, b, hq, hkv, s, w, hd)
    out, ref_j, pallas, tx = _run_both(arrays, dtype, n_hot=w // psz)
    assert out.shape == (b, 1, hq, hd) and out.dtype == TORCH_DT[dtype]
    assert torch.equal(out, TR.paged_attention_ref(*tx))
    for name, ref in (("jit ref.paged_attention_ref", ref_j),
                      ("ops.decode_paged_attention (Pallas interpret)", pallas)):
        _assert_close(out, ref, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_fully_masked_rows_are_neutral(dtype):
    """Only position 0 attendable (the rest -1e30): finite, and equal to the
    JAX oracle and the Pallas kernel within tolerance."""
    q, kh, vh, kc, vc, sel, _ = _paged_inputs(0, 2, 4, 2, 32, 8, 16)
    mask = np.broadcast_to(np.where(np.arange(32)[None, :] < 1, 0.0, -1e30),
                           (2, 32)).astype(np.float32).copy()
    out, ref_j, pallas, _ = _run_both((q, kh, vh, kc, vc, sel, mask), dtype, n_hot=4)
    assert torch.isfinite(out.float()).all()
    for ref in (ref_j, pallas):
        _assert_close(out, ref, dtype)


def test_paged_attention_every_row_masked_matches_oracle():
    """All rows masked: the softmax weighs every row equally, as the JAX
    oracle does."""
    q, kh, vh, kc, vc, sel, _ = _paged_inputs(3, 2, 8, 2, 32, 16, 32)
    mask = np.full((2, 32), -1e30, np.float32)
    out, ref_j, _, _ = _run_both((q, kh, vh, kc, vc, sel, mask), "float32", n_hot=2)
    _assert_close(out, ref_j, "float32")


# ---------------------------------------------------------------------------
# The CUDA wrappers refuse what their kernels do not take
# ---------------------------------------------------------------------------
def test_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(torch.ones(2, 8), torch.ones(8))
    tx = [torch.from_numpy(a) for a in _paged_inputs(1, 1, 4, 2, 16, 8, 64)]
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(*tx, n_hot=2)
    with pytest.raises(ValueError, match="no kernel"):
        K.fused_rmsnorm(torch.ones(2, 8, device="meta"), torch.ones(8, device="meta"))
