"""Device resolution and the CUDA-kernel capability check.

Entry points of the port run on ``cuda`` unless the caller passes
``device="cpu"`` (the CPU tests do). There is no silent fallback: asking for
the default device on a machine without CUDA raises.
"""
from __future__ import annotations

import os
import shutil

import torch

NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` -> ``cuda`` (raises if CUDA is absent); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run the plain "
                "PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def find_nvcc() -> str | None:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    return NVCC_DEFAULT if os.path.exists(NVCC_DEFAULT) else None


def cuda_kernel_problems() -> list[str]:
    """What is missing for the hand-written Hopper kernels (empty: all set)."""
    problems = []
    if not torch.cuda.is_available():
        problems.append("CUDA is not available to torch")
    else:
        major, minor = torch.cuda.get_device_capability(0)
        if (major, minor) < (9, 0):
            problems.append(f"compute capability {major}.{minor} < 9.0 (sm_90a kernels)")
    if find_nvcc() is None:
        problems.append("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin)")
    return problems


def require_cuda_kernels() -> None:
    """Raise with a message naming everything missing for the CUDA kernels."""
    problems = cuda_kernel_problems()
    if problems:
        raise RuntimeError("CUDA kernels unavailable: " + "; ".join(problems))
