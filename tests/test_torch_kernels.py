"""The port's kernels against the JAX package's.

On the CPU the port's kernels package runs the plain versions
(``repro_torch.kernels.ref``); they are held against the JAX oracles
(``repro.kernels.ref``), the Pallas kernels in interpret mode, and the model
path's ``layers.rmsnorm``. Tolerances, as ``atol = rtol`` after casting to
fp32: fp32 1e-4 (XLA and torch sum in different orders), bf16 2e-2 (the bf16
bound of tests/test_kernels.py). The training kernels' plain versions
(FlashAttention forward with its log-sum-exp, its backward, fused Adam, the
RMSNorm backward) are compared in fp32 at 1e-4 as well. The fused int8
quantize's plain version is held **bitwise** to the JAX oracle and to the
Pallas kernel in interpret mode (q, scales and the residual). The CUDA
kernels are held against the same plain versions on the card in
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as JOPS
from repro.kernels import ref as JR
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.fused_adam import fused_adam as j_fused_adam
from repro.kernels.fused_quant import fused_quantize_ef as j_fused_quantize_ef
from repro.models import layers as JL
from repro.optim import adam as JADAM
from repro_torch import kernels as K
from repro_torch.kernels import ref as TR
from repro_torch.optim import adam as TADAM

import torch_cores

torch_cores.share_cores()

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
# Paged attention, split-KV: the CUDA kernel's split choice and a plain model
# of its split-and-combine arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,hkv,s,page,sms", [
    (4, 8, 1024, 256, 132),    # the serving shape: 8 splits of half a page
    (4, 8, 65536, 256, 132),   # a long cache: whole pages a split
    (1, 1, 8, 8, 132),         # tiny S: one split
    (1, 1, 65536, 256, 132),   # one (b, h): many splits of one page
    (2, 2, 65536, 256, 132),   # a ragged last split (86 splits of 768 rows)
    (3, 2, 1408, 64, 132),     # page-sized splits
    (2, 8, 40, 8, 4),          # few SMs: whole row
    (64, 8, 4096, 256, 132),   # many (b, h): one split each
])
def test_paged_split_rows_cover_the_row_on_page_bounds(b, hkv, s, page, sms):
    from repro_torch.kernels.paged_attention import split_rows

    rows, n = split_rows(b, hkv, s, page, sms)
    assert n >= 1 and rows >= 1
    covered = [r for i in range(n) for r in range(i * rows, min((i + 1) * rows, s))]
    assert covered == list(range(s))  # every row once, in order; no empty split
    assert rows % page == 0 or page % rows == 0 or rows == s  # bounds on page bounds
    if n > 1:
        assert rows >= min(64, s)


def _split_cases(s):
    """rows_per_split values: one row, a ragged split, half the row, all of it."""
    return sorted({1, max(1, s // 3 + 1), max(1, s // 2), s})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,w,psz,hd", SWEEP)
def test_paged_split_model_matches_jax(b, hq, hkv, s, w, psz, hd, dtype):
    """The split-and-combine model against the port's plain version, the
    jitted JAX oracle and the Pallas kernel in interpret mode, for several
    split sizes (one row a split, a ragged last split, the whole row)."""
    arrays = _paged_inputs(s + w + 1, b, hq, hkv, s, w, hd)
    _, ref_j, pallas, tx = _run_both(arrays, dtype, n_hot=w // psz)
    plain = TR.paged_attention_ref(*tx)
    for rows in _split_cases(s):
        out = TR.paged_attention_split_ref(*tx, rows_per_split=rows)
        assert out.shape == plain.shape and out.dtype == plain.dtype
        for name, ref in (("plain", plain), ("jit ref.paged_attention_ref", ref_j),
                          ("ops.decode_paged_attention (Pallas interpret)", pallas)):
            _assert_close(out, ref, dtype, f"rows_per_split={rows} vs {name}")


def _mask_case(case: str, b: int, s: int) -> np.ndarray:
    mask = np.zeros((b, s), np.float32)
    if case == "masked_split":  # the first half masked, the rest attendable
        mask[:, : s // 2] = -1e30
    elif case == "all_masked":
        mask[:] = -1e30
    else:  # one attendable row, in the middle of a split
        mask[:] = -1e30
        mask[:, s // 2 + 1] = 0.0
    return mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["masked_split", "all_masked", "one_row"])
def test_paged_split_model_masked_splits(case, dtype):
    """A split wholly masked beside attendable rows enters the merge with
    weight 0; every row masked weighs all rows equally (the oracle's
    softmax over equal logits); one attendable row gives its V row."""
    b, hq, hkv, s, w = 2, 8, 2, 64, 16
    q, kh, vh, kc, vc, sel, _ = _paged_inputs(7, b, hq, hkv, s, w, 32)
    mask = _mask_case(case, b, s)
    _, ref_j, pallas, tx = _run_both((q, kh, vh, kc, vc, sel, mask), dtype, n_hot=2)
    for rows in (8, 16, 24):
        out = TR.paged_attention_split_ref(*tx, rows_per_split=rows)
        assert torch.isfinite(out.float()).all()
        for name, ref in (("plain", TR.paged_attention_ref(*tx)), ("jit ref", ref_j),
                          ("Pallas interpret", pallas)):
            _assert_close(out, ref, dtype, f"{case} rows_per_split={rows} vs {name}")
    if case == "one_row":  # the output is that row's V, whichever split holds it
        r = s // 2 + 1
        v_row = np.where(sel[:, r, None, None], vh[:, r % w], vc[:, r])  # (b, hkv, hd)
        want = np.repeat(v_row, hq // hkv, axis=1)[:, None]
        _assert_close(TR.paged_attention_split_ref(*tx, rows_per_split=8), want.astype(np.float32),
                      dtype, "one attendable row")


# ---------------------------------------------------------------------------
# FlashAttention: a subset of tests/test_kernels.py:23-42's sweep
# ---------------------------------------------------------------------------
FLASH_SWEEP = [  # (b, hq, hkv, s, hd, window)
    (1, 4, 4, 128, 64, 0),    # MHA
    (2, 8, 2, 128, 64, 0),    # GQA 4:1
    (1, 8, 1, 64, 32, 0),     # MQA
    (2, 4, 4, 100, 64, 0),    # ragged S
    (2, 8, 2, 128, 64, 48),   # sliding window 48
]


@pytest.mark.parametrize("b,hq,hkv,s,hd,window", FLASH_SWEEP)
def test_flash_attention_plain_matches_jax(b, hq, hkv, s, hd, window):
    rng = np.random.default_rng(s + hq + window)
    q = rng.standard_normal((b, hq, s, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, s, hd)).astype(np.float32) for _ in range(2))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = TR.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    for name, ref in (("ref.flash_attention_ref",
                       JR.flash_attention_ref(jq, jk, jv, causal=True, window=window)),
                      ("flash_attention (Pallas interpret)",
                       j_flash(jq, jk, jv, causal=True, window=window, block_q=64, block_k=64,
                               interpret=True))):
        _assert_close(out, ref, "float32", name)
    # the kernels package's CPU route, in the model's (B, S, H, hd) layout
    o2, lse = K.flash_attention(*(t.transpose(1, 2) for t in (tq, tk, tv)), window=window)
    _assert_close(o2.transpose(1, 2), out, "float32", "attention_lse_ref")
    assert lse.shape == (b, hq, s) and torch.isfinite(lse).all()


def test_flash_attention_bwd_plain_matches_jax_grad():
    """The whole-row backward against jax.vjp of the JAX oracle."""
    rng = np.random.default_rng(11)
    b, hq, hkv, s, hd, window = 2, 8, 2, 96, 32, 40
    q, do = (rng.standard_normal((b, s, hq, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, hkv, hd)).astype(np.float32) for _ in range(2))
    bhsd = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)  # noqa: E731
    _, vjp = jax.vjp(lambda q, k, v: JR.flash_attention_ref(q, k, v, causal=True, window=window),
                     bhsd(q), bhsd(k), bhsd(v))
    jgrads = [jnp.swapaxes(g, 1, 2) for g in vjp(bhsd(do))]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = K.flash_attention(tq, tk, tv, window=window)
    grads = K.flash_attention_bwd(tq, tk, tv, out, lse, tdo, window=window)
    for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        _assert_close(got, want, "float32", name)


# The flash forward kernel's arithmetic (64- or 128-key tiles over each
# 64-row query tile's live range, online softmax in the log2 domain, p
# rounded against the running max) in plain PyTorch, against the whole-row plain version, the JAX
# training path's _mea_forward and the Pallas kernel in interpret mode, in
# fp32 and bf16 (TOL: 1e-4 fp32, 2e-2 bf16, as atol = rtol; the fp32 lse at
# 1e-4 in both), on every row. The JAX versions mask additively at -1e30, so
# a row with no attended key averages V over the padded key range; the port
# matches that (ref.fix_unattended_fwd), here with the keys padded to the
# 64-key blocks both JAX versions run with. The Pallas kernel has no query
# offset.
TILED_CASES = [(b, hq, hkv, s, s, hd, window, 0, True) for b, hq, hkv, s, hd, window in FLASH_SWEEP]
TILED_CASES += [  # (b, hq, hkv, sq, sk, hd, window, q_offset, causal)
    (1, 4, 2, 200, 200, 64, 70, 0, True),    # S and the window off the 64-row tiles
    (1, 4, 2, 130, 130, 64, 0, 0, False),    # no causal mask, ragged S
    (2, 4, 1, 100, 164, 32, 0, 64, True),    # queries at 64..163 over 164 keys
    (1, 4, 2, 150, 60, 32, 40, 37, True),    # rows 62..149 attend no key
    (1, 4, 2, 200, 100, 32, 30, 0, True),    # rows 129..199 attend no key; Pallas too
]


def _jax_mea(jq, jk, jv, sk, causal, window, q_offset, block=64):
    """_mea_forward on K / V padded to ``block``-key blocks: out in q's
    dtype, lse (B, Hq, Sq), both fp32 numpy in the port's layouts."""
    b, sq, hq, hd = jq.shape
    hkv = jk.shape[2]
    pad = -sk % block
    kp, vp = (jnp.pad(a, ((0, 0), (0, pad), (0, 0), (0, 0))) for a in (jk, jv))
    mea, mea_lse = JL._mea_forward(jq.reshape(b, sq, hkv, hq // hkv, hd), kp, vp, sk, causal,
                                   window, q_offset, block)
    mea = np.asarray(mea.astype(jq.dtype).astype(jnp.float32)).reshape(b, sq, hq, hd)
    return mea, np.asarray(mea_lse).reshape(b, sq, hq).transpose(0, 2, 1)


@pytest.mark.parametrize("key_tile", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,hd,window,q_offset,causal", TILED_CASES)
def test_flash_tiled_model_matches_jax(b, hq, hkv, sq, sk, hd, window, q_offset, causal, dtype,
                                       key_tile):
    rng = np.random.default_rng(sq + 7 * sk + hd + window + q_offset)
    jq, tq = _both(rng.standard_normal((b, sq, hq, hd)).astype(np.float32), dtype)
    jk, tk = _both(rng.standard_normal((b, sk, hkv, hd)).astype(np.float32), dtype)
    jv, tv = _both(rng.standard_normal((b, sk, hkv, hd)).astype(np.float32), dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset, block_kv=64)
    out, lse = TR.flash_attention_tiled_ref(tq, tk, tv, key_tile=key_tile, **kw)
    assert out.dtype == tq.dtype and lse.shape == (b, hq, sq)
    want, want_lse = TR.attention_lse_ref(tq, tk, tv, **kw)
    _assert_close(out, want, dtype, "attention_lse_ref")
    _assert_close(lse, want_lse, "float32", "attention_lse_ref lse")
    attended = TR._mask(sq, sk, causal, window, q_offset, "cpu").any(dim=1).numpy()
    if not attended.all():  # rows with nothing attended: V averaged, lse -1e30
        assert out[:, ~attended].float().abs().amax() > 0
        assert bool((lse[:, :, ~attended] == -1e30).all())

    mea, mea_lse = _jax_mea(jq, jk, jv, sk, causal, window, q_offset)
    _assert_close(out, mea, dtype, "_mea_forward")
    _assert_close(lse, mea_lse, "float32", "_mea_forward lse")
    if q_offset == 0:
        bhsd = lambda a: jnp.swapaxes(a, 1, 2)  # noqa: E731
        pallas = j_flash(bhsd(jq), bhsd(jk), bhsd(jv), causal=causal, window=window, block_q=64,
                         block_k=64, interpret=True)
        pallas = np.asarray(bhsd(pallas).astype(jnp.float32))
        _assert_close(out, pallas, dtype, "Pallas interpret")


# Rows with nothing attended through the kernels package's CPU route (the
# plain versions), forward and backward, against the JAX training path's
# _mea_forward / _mea_bwd (fp32, TOL 1e-4) with keys padded to 128-key
# blocks, on shapes whose unattended rows lie at a causal head (negative
# positions), a windowed tail, or both.
UNATTENDED_CASES = [  # (sq, sk, window, q_offset, causal)
    (96, 40, 16, 0, True),     # rows 55..95 past the window of the last key
    (64, 50, 0, -20, True),    # rows 0..19 at negative positions
    (80, 30, 12, -10, True),   # both
    (48, 20, 8, 0, False),     # no causal mask, windowed tail
    (16, 8, 4, 100, True),     # every row
]


@pytest.mark.parametrize("sq,sk,window,q_offset,causal", UNATTENDED_CASES)
def test_unattended_rows_match_mea_fwd_and_bwd(sq, sk, window, q_offset, causal):
    b, hq, hkv, hd = 2, 4, 2, 32
    rng = np.random.default_rng(sq * sk + window)
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, sq, hq, hd), (b, sk, hkv, hd), (b, sk, hkv, hd), (b, sq, hq, hd))]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrs)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in arrs)
    rows = TR.unattended_rows(sq, sk, causal, window, q_offset)
    attended = TR._mask(sq, sk, causal, window, q_offset, "cpu").any(dim=1)
    assert [i for a, c in rows for i in range(a, c)] == (~attended).nonzero().flatten().tolist()
    assert rows, "the case must have rows with nothing attended"
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = K.flash_attention(tq, tk, tv, block_kv=128, **kw)
    mea, mea_lse = _jax_mea(jq, jk, jv, sk, causal, window, q_offset, block=128)
    _assert_close(out, mea, "float32", "_mea_forward")
    _assert_close(lse, mea_lse, "float32", "_mea_forward lse")

    g = hq // hkv
    pad = -sk % 128
    kp, vp = (jnp.pad(a, ((0, 0), (0, pad), (0, 0), (0, 0))) for a in (jk, jv))
    q5 = jq.reshape(b, sq, hkv, g, hd)
    jout, jlse = JL._mea_forward(q5, kp, vp, sk, causal, window, q_offset, 128)
    jgrads = JL._mea_bwd(sk, causal, window, q_offset, 128, (q5, kp, vp, jout, jlse),
                         jdo.reshape(b, sq, hkv, g, hd))
    grads = K.flash_attention_bwd(tq, tk, tv, out, lse, tdo, **kw)
    for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        want = np.asarray(want)[:, :sk] if name != "dq" else np.asarray(want)
        _assert_close(got, want.reshape(got.shape), "float32", name)


# ---------------------------------------------------------------------------
# Fused Adam and the RMSNorm backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_fused_adam_plain_matches_jax(weight_decay):
    rng = np.random.default_rng(5)
    shape = (128, 257)
    p, g, master = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    m = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    v = (0.01 * np.abs(rng.standard_normal(shape))).astype(np.float32)
    hp = dict(lr=3e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=weight_decay, bc1=0.271,
              bc2=0.142625)
    scal = jnp.asarray([hp["lr"], hp["b1"], hp["b2"], hp["eps"], weight_decay, hp["bc1"],
                        hp["bc2"], 0.0], jnp.float32)
    pallas = j_fused_adam(*(jnp.asarray(a) for a in (p, g, master, m, v)), scal, interpret=True)
    jref = JR.fused_adam_ref(*(jnp.asarray(a) for a in (p, g, master, m, v)), **hp)
    tensors = [torch.from_numpy(a.copy()) for a in (p, g, master, m, v)]
    plain = TR.fused_adam_ref(*tensors, **hp)
    inplace = K.fused_adam_update(*tensors, torch.from_numpy(np.array(scal)))
    for i, name in enumerate(("p", "master", "m", "v")):
        for ref_name, ref in (("ref", jref[i]), ("Pallas interpret", pallas[i])):
            _assert_close(plain[i], ref, "float32", f"{name} vs {ref_name}")
        _assert_close(inplace[i], plain[i], "float32", f"{name} in place")
    assert inplace[1] is tensors[2]  # the update wrote the state tensor itself

    # one adam_update step of a one-leaf tree, against the JAX optimizer
    cfg = JADAM.AdamConfig(lr=3e-3, weight_decay=weight_decay)
    jstate = {"master": {"w": jnp.asarray(master)}, "m": {"w": jnp.asarray(m)},
              "v": {"w": jnp.asarray(v)}, "count": jnp.asarray(2, jnp.int32)}
    jp, jst, jnorm = JADAM.adam_update({"w": jnp.asarray(p)}, {"w": jnp.asarray(g)}, jstate,
                                       cfg, cfg.lr)
    tcfg = TADAM.AdamConfig(lr=3e-3, weight_decay=weight_decay)
    tstate = {"master": {"w": torch.from_numpy(master.copy())},
              "m": {"w": torch.from_numpy(m.copy())}, "v": {"w": torch.from_numpy(v.copy())},
              "count": 2}
    tp = {"w": torch.from_numpy(p.copy())}
    tnorm = TADAM.adam_update(tp, {"w": torch.from_numpy(g.copy())}, tstate, tcfg, tcfg.lr)
    _assert_close(tnorm, jnorm, "float32", "grad norm")
    _assert_close(tp["w"], jp["w"], "float32", "adam_update p")
    for key in ("master", "m", "v"):
        _assert_close(tstate[key]["w"], jst[key]["w"], "float32", f"adam_update {key}")
    assert tstate["count"] == 3


# The copy-engine pipeline of a leaf with pinned states cuts it into
# segments; the update is elementwise, so segment by segment it must equal
# the whole-leaf update bit for bit.
@pytest.mark.parametrize("n,seg", [(0, 8), (3, 8), (8, 8), (37, 8), (4096, 1024), (4099, 1024),
                                   (3 * 1024 + 13, 1024), (10, 4 << 20)])
def test_fused_adam_segments_cover_every_element_once(n, seg):
    from repro_torch.kernels.fused_adam import segments

    segs = segments(n, seg)
    assert [i for start, length in segs for i in range(start, start + length)] == list(range(n))
    assert all(start % 4 == 0 and 0 < length <= seg for start, length in segs)
    assert len(segs) == -(-n // seg)
    with pytest.raises(ValueError, match="multiple of 8"):
        segments(n, 12)


@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,seg", [(37, 8), (4096, 1024), (4099, 1024)])
def test_fused_adam_plain_update_by_segments_is_bitwise(n, seg, g_dtype):
    from repro_torch.kernels.fused_adam import segments

    rng = np.random.default_rng(n + seg)
    master, g = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    m = (0.1 * rng.standard_normal(n)).astype(np.float32)
    v = (0.01 * np.abs(rng.standard_normal(n))).astype(np.float32)
    scalars = torch.tensor([3e-3, 0.9, 0.95, 1e-8, 0.1, 0.271, 0.142625, 0.0])

    def leaf():
        return [torch.from_numpy(master).bfloat16(), torch.from_numpy(g).to(TORCH_DT[g_dtype])] + [
            torch.from_numpy(a.copy()) for a in (master, m, v)]

    whole = leaf()
    K.fused_adam_update(*whole, scalars)
    pieces = leaf()
    for start, length in segments(n, seg):
        K.fused_adam_update(*(t[start:start + length] for t in pieces), scalars)
    bits = lambda t: t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)  # noqa: E731
    for name, a, b in zip(("p", "g", "master", "m", "v"), pieces, whole):
        assert torch.equal(bits(a), bits(b)), name


@pytest.mark.parametrize("shape", [(4, 128), (2, 3, 64)])
def test_rmsnorm_bwd_plain_matches_jax_grad(shape):
    rng = np.random.default_rng(9)
    x, dy = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    s = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    _, vjp = jax.vjp(JR.rmsnorm_ref, jnp.asarray(x), jnp.asarray(s))
    jdx, jds = vjp(jnp.asarray(dy))
    tx, ts, tdy = (torch.from_numpy(a) for a in (x, s, dy))
    dx, ds = TR.rmsnorm_bwd_ref(tx, ts, tdy)
    _assert_close(dx, jdx, "float32", "dx")
    _assert_close(ds, jds, "float32", "dscale")
    # the kernels package differentiates through it
    xr, sr = tx.clone().requires_grad_(), ts.clone().requires_grad_()
    gx, gs = torch.autograd.grad(K.fused_rmsnorm(xr, sr), (xr, sr), tdy)
    assert torch.equal(gx, dx) and torch.equal(gs, ds)


# ---------------------------------------------------------------------------
# Fused int8 quantize + error-feedback residual: bitwise against JAX
# ---------------------------------------------------------------------------
def _quant_both(ch: np.ndarray, me: int, dtype=torch.float32):
    """(port plain, JAX oracle, Pallas interpret) results as numpy triples;
    the port takes ``ch`` in ``dtype`` (values ``dtype`` holds exactly)."""
    port = K.fused_quantize_ef(torch.from_numpy(ch).to(dtype), me)
    jref = JR.fused_quantize_ef_ref(jnp.asarray(ch), me)
    pallas = j_fused_quantize_ef(jnp.asarray(ch), me, interpret=True)
    out = [tuple(t.numpy() for t in port)]
    out += [tuple(np.asarray(a) for a in r) for r in (jref, pallas)]
    return out


def _xla_cpu_quantize(ch: np.ndarray, me: int):
    """What XLA's CPU backend compiles the Pallas kernel (and any jitted
    three-op sequence) into: the division by the constant 127 becomes a
    multiply by fp32(1/127), and ``ch - q * scale`` one fused multiply-add
    (the exact difference rounded once; exact in fp64, since q is an integer
    of at most 7 bits)."""
    amax = np.abs(ch).max(axis=1)
    scale = np.maximum(amax, np.float32(1e-30)) * np.float32(1.0 / 127.0)
    q = np.clip(np.rint(ch / scale[:, None]), -127, 127).astype(np.int8)
    err = ch[me].astype(np.float64) - q[me].astype(np.float64) * np.float64(scale[me])
    return q, scale.astype(np.float32), err.astype(np.float32)


def _assert_quant_bitwise(ch: np.ndarray, me: int, dtype=torch.float32):
    """The port's plain version bitwise against the JAX oracle run op by op
    (IEEE division, the product rounded before the difference, as the CUDA
    kernel computes). The Pallas kernel in interpret mode is jitted, and
    XLA's CPU backend rewrites two of those ops (``_xla_cpu_quantize``): it
    is held bitwise against that rewrite, whose q differs from the port's
    only where the rewritten scale is an ulp away."""
    (q, s, e), (qj, sj, ej), (qp, sp, ep) = _quant_both(ch, me, dtype)
    assert q.dtype == np.int8 and s.dtype == np.float32 and e.dtype == np.float32
    np.testing.assert_array_equal(q, qj, err_msg="q vs JAX ref")
    np.testing.assert_array_equal(s.view(np.int32), sj.view(np.int32), err_msg="scales vs JAX ref")
    np.testing.assert_array_equal(e.view(np.int32), ej.view(np.int32), err_msg="err vs JAX ref")
    qx, sx, ex = _xla_cpu_quantize(ch, me)
    np.testing.assert_array_equal(qp, qx, err_msg="Pallas interpret q")
    np.testing.assert_array_equal(sp.view(np.int32), sx.view(np.int32),
                                  err_msg="Pallas interpret scales")
    np.testing.assert_array_equal(ep.view(np.int32), ex.view(np.int32),
                                  err_msg="Pallas interpret err")
    same = sx.view(np.int32) == s.view(np.int32)  # rows whose scales agree agree in q
    np.testing.assert_array_equal(qp[same], q[same], err_msg="q where the scales agree")


@settings(max_examples=30, deadline=None)
@given(z=st.integers(min_value=1, max_value=4), n=st.integers(min_value=1, max_value=257),
       me=st.integers(min_value=0, max_value=3), seed=st.integers(min_value=0, max_value=2**16),
       log_spread=st.integers(min_value=-3, max_value=4))
def test_fused_quantize_ef_plain_matches_jax_bitwise(z, n, me, seed, log_spread):
    rng = np.random.default_rng(seed)
    ch = (rng.standard_normal((z, n)) * np.exp(rng.standard_normal((z, 1)) * log_spread))
    _assert_quant_bitwise(ch.astype(np.float32), me % z)


def test_fused_quantize_ef_edge_rows_match_jax_bitwise():
    """A zero row (scale 1e-30 / 127), exact half-way quotients (round half
    to even), values at the clip bound, n not a multiple of 4."""
    n = 131
    ties = np.zeros(n, np.float32)
    ties[0] = 127.0  # scale exactly 1: every x / scale is x
    ties[1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    clip = np.linspace(-1.0, 1.0, n).astype(np.float32) * np.float32(3.3)
    ch = np.stack([np.zeros(n, np.float32), ties, clip, -clip])
    for me in range(4):
        _assert_quant_bitwise(ch, me)
    q, s, _ = (t.numpy() for t in K.fused_quantize_ef(torch.from_numpy(ch), 0))
    assert s[0] == np.float32(1e-30) / np.float32(127) and not q[0].any()
    assert list(q[1, 1:9]) == [0, 2, 2, 0, -2, -2, 126, -126]  # half to even
    assert q[2].min() == -127 and q[2].max() == 127


# (z, n, dtype): the widest configs' rows (d 18432 in fp32, 16384 in bf16),
# bf16 rows with n % 8 == 4 (the kernel's 8-byte loads), 9 rows (not a
# whole number of the kernel's 8-row blocks) and one row of d 768
QUANT_EDGE_WIDTHS = [(1, 18432, torch.float32), (2, 16384, torch.bfloat16),
                     (3, 4100, torch.bfloat16), (9, 12, torch.bfloat16),
                     (1, 768, torch.bfloat16)]


@pytest.mark.parametrize("z,n,dtype", QUANT_EDGE_WIDTHS)
def test_fused_quantize_ef_plain_matches_jax_bitwise_at_kernel_widths(z, n, dtype):
    """The plain version bitwise against JAX at the widths where the CUDA
    kernel changes its launch; a bf16 input is widened exactly, so JAX gets
    the same values in fp32. The first row holds a half-way quotient and
    the clip bound, every row a -0.0."""
    rng = np.random.default_rng(n)
    ch = rng.standard_normal((z, n)) * np.exp(rng.standard_normal((z, 1)))
    ch[0, :3] = [127.0, 2.5, -126.5]  # scale 1: x / scale is x
    ch[:, 3] = -0.0  # q 0; the residual keeps the sign of x
    ch = torch.from_numpy(ch.astype(np.float32)).to(dtype).float().numpy()
    _assert_quant_bitwise(ch, z - 1, dtype)
    q, _, _ = K.fused_quantize_ef(torch.from_numpy(ch).to(dtype), 0)
    assert q[0, :3].tolist() == [127, 2, -126]


def test_quant_plan_runs_every_config_width_in_one_pass():
    """Every d_model of the configs (768 to 18432), in bf16 and fp32, at a
    microbatch's rows and at one row: one kernel that reads x once (the rows
    path: 16-byte loads held in registers), within the card's limits (1024
    threads a block, 2^31 - 1 blocks) and the kernel's instances."""
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels.fused_quant import LOAD_SLOTS, quant_plan

    widths = sorted({c.d_model for c in REGISTRY.values()})
    assert widths[0] == 768 and widths[-1] == 18432
    for d in widths:
        for dtype, vec in ((torch.bfloat16, 8), (torch.float32, 4)):
            for z in (1, 257, 32768):
                p = quant_plan(z, d, dtype)
                assert p.path == "rows" and p.passes == 1 and p.vec == vec, (d, dtype, p)
                assert 32 <= p.threads_per_row <= p.threads <= 1024, (d, dtype, p)
                assert p.threads == p.threads_per_row * p.rows, (d, dtype, p)
                assert p.loads_per_thread in LOAD_SLOTS, (d, dtype, p)
                assert p.threads_per_row * p.loads_per_thread * p.vec >= d, (d, dtype, p)
                assert p.blocks * p.rows >= z and p.blocks < 2 ** 31, (d, dtype, p)
    # two blocks of d 18432 bf16 share an SM; the gradient wire's chunks take
    # two passes; odd widths take 8-byte loads (bf16, n % 8 == 4) or one value
    assert quant_plan(4096, 18432, torch.bfloat16).threads == 512
    assert quant_plan(4, 14_680_064, torch.float32).passes == 2
    assert quant_plan(4, 4100, torch.bfloat16).vec == 4
    assert quant_plan(4, 4099, torch.float32).vec == 1


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
    from repro_torch.kernels.flash_cuda import flash_attention_cuda
    from repro_torch.kernels.fused_adam import fused_adam_cuda

    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    z = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam_cuda(z, z, z, z, z, z)
    from repro_torch.kernels.fused_quant import fused_quantize_ef_cuda

    with pytest.raises(ValueError, match="CUDA"):
        fused_quantize_ef_cuda(torch.zeros(2, 8), 0)
