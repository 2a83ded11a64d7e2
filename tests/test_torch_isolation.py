"""The PyTorch port stands alone: no jax, nothing of ``repro``, its own
config registry equal to the JAX package's, and no silent CPU fallback."""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro import configs as JC
from repro_torch import configs as TC
from repro_torch.compat import cuda_kernel_problems, require_cuda_kernels, resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_or_repro(path):
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")}
    assert not bad, f"{path}: imports {sorted(bad)}"


def test_port_modules_load_without_jax():
    mods = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("name", sorted(JC.REGISTRY))
def test_config_equals_jax_twin(name):
    j, t = JC.get_config(name), TC.get_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    jr, tr = JC.reduced(j, num_kv_heads=2), TC.reduced(t, num_kv_heads=2)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)


def test_shapes_equal_jax_twins():
    for j, t in zip(JC.base.ALL_SHAPES, TC.base.ALL_SHAPES):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_capability_check_names_what_is_missing():
    if not cuda_kernel_problems():
        pytest.skip("this host can build the CUDA kernels")
    with pytest.raises(RuntimeError, match="CUDA kernels unavailable"):
        require_cuda_kernels()
