"""The port's layers, parameter trees and weight transfer against the JAX
package's, on the same inputs made with numpy. Tolerances (``atol = rtol``,
after casting to fp32): fp32 1e-4, bf16 2e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _assert_close(out: torch.Tensor, ref, dtype: str):
    a = out.float().numpy()
    b = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    tol = TOL[dtype]
    assert a.shape == b.shape
    assert (np.abs(a - b) <= tol * (1.0 + np.abs(b))).all(), np.abs(a - b).max()


def _both(a: np.ndarray, dtype: str):
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(TORCH_DT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_slot", [False, True])
def test_rope_matches_jax(dtype, per_slot):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 1, 4, 32)).astype(np.float32)
    pos = np.array([5, 900, 4095]) if per_slot else np.array(77)
    jpos = jnp.asarray(pos, jnp.int32)
    jpos = jpos[:, None] if per_slot else jnp.full((1,), jpos)
    tpos = torch.from_numpy(pos)
    tpos = tpos[:, None] if per_slot else tpos.reshape(1)
    xj, xt = _both(x, dtype)
    for theta in (10_000.0, 500_000.0):
        _assert_close(TL.apply_rope(xt, tpos, theta), JL.apply_rope(xj, jpos, theta), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["swiglu", "gelu", "relu2", "geglu"])
def test_mlp_matches_jax(kind, dtype):
    cfg = dataclasses.replace(reduced(get_config("mistral-7b")), mlp=kind)
    rng = np.random.default_rng(2)
    defs = JL.mlp_defs(cfg)
    w = {k: (rng.standard_normal(d.shape) / np.sqrt(d.shape[0])).astype(np.float32)
         for k, d in defs.items()}
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    pj = {k: _both(v, dtype)[0] for k, v in w.items()}
    pt = {k: _both(v, dtype)[1] for k, v in w.items()}
    xj, xt = _both(x, dtype)
    _assert_close(TL.apply_mlp(pt, xt, kind), JL.apply_mlp(pj, xj, kind), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, 128)).astype(np.float32) * 2
    s = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(128)).astype(np.float32)
    (xj, xt), (sj, st), (bj, bt) = _both(x, dtype), _both(s, dtype), _both(bias, dtype)
    _assert_close(TL.layernorm(xt, st, bt), JL.layernorm(xj, sj, bj), dtype)
    _assert_close(TL.apply_norm({"scale": st}, xt, "rmsnorm"),
                  JL.apply_norm({"scale": sj}, xj, "rmsnorm"), dtype)


def _shapes(tree) -> dict:
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("name", ["mistral-7b", "gpt2-1b", "llama3-405b", "opt-13b"])
def test_param_defs_match_jax(name):
    cfg = reduced(get_config(name), num_kv_heads=2)
    j = jax.tree.map(lambda d: (d.shape, d.axes, d.init, d.scale, d.dtype),
                     JM.param_defs(cfg), is_leaf=lambda x: isinstance(x, JL.ParamDef))
    t = TL.map_defs(lambda d: (d.shape, d.axes, d.init, d.scale, d.dtype), TM.param_defs(cfg))
    assert t == j
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))
    assert _shapes(params) == jax.tree.map(
        lambda s: (tuple(s.shape), TL.torch_dtype(str(s.dtype))), jp)


def test_decoder_module_names_are_tree_paths():
    cfg = reduced(get_config("mistral-7b"), num_kv_heads=2)
    model = TM.DecoderLM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    names = dict(model.named_parameters())
    r = TM.num_repeats(cfg)
    hd = cfg.resolved_head_dim
    assert names["blocks.pos0.attn.wq"].shape == (r, cfg.d_model, cfg.num_heads * hd)
    assert names["embed.tok"].shape == (cfg.vocab_size, cfg.d_model)
    assert "head.w" in names and "final_norm.scale" in names
    tree = model.tree()
    assert tree["blocks"]["pos0"]["mlp"]["w1"] is names["blocks.pos0.mlp.w1"]
    # the same generator seed gives the same parameters
    again = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["blocks"]["pos0"]["attn"]["wk"],
                       tree["blocks"]["pos0"]["attn"]["wk"])


@pytest.mark.parametrize("name", ["mixtral-8x22b", "mamba2-130m", "seamless-m4t-large-v2"])
def test_other_families_raise_with_roadmap_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.param_defs(reduced(get_config(name)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_convert_is_bit_exact(dtype):
    cfg = dataclasses.replace(reduced(get_config("mistral-7b"), num_kv_heads=2), dtype=dtype)
    jp = jax.device_get(JM.init_params(cfg, jax.random.PRNGKey(0)))
    tp = convert.tree_from_numpy(jp)
    assert tp["blocks"]["pos0"]["attn"]["wq"].dtype == TORCH_DT[dtype]
    back = convert.tree_to_numpy(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, a in flat_j:
        b = flat_b[path]
        assert b.dtype == a.dtype
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path
