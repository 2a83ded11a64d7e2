"""Build and load the hand-written CUDA kernels; count their launches.

The ``csrc/*.cu`` sources are compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded through ``ctypes``. Each
source compiles in its own ``nvcc`` process, all started together, then one
link step joins them. The library lands in ``build/repro_torch/`` under the
checkout, named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Nothing is built at import:
the first wrapper call builds (``load_library``).

Each wrapper adds one to its launch count where it launches its kernel, and
nowhere else (``count_launch``); a caller reads the counts with
``launch_counts`` and zeroes them with ``reset_launch_counts``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from repro_torch.compat import find_nvcc, require_cuda_kernels

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("rmsnorm", "paged_attention")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIB: ctypes.CDLL | None = None
BUILD_INFO: dict = {}
_LAUNCHES = dict.fromkeys(KERNELS, 0)


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(nvcc: str) -> str:
    h = hashlib.sha256(" ".join((nvcc,) + NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> pathlib.Path:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, in parallel) and link
    them into one shared library; returns its path. Reuses a library built
    from identical sources and flags."""
    require_cuda_kernels()
    nvcc = find_nvcc()
    lib_path = BUILD_DIR / f"libreprotorch_{_digest(nvcc)}.so"
    if lib_path.exists():
        BUILD_INFO.update(lib=str(lib_path), seconds=0.0, built=False, log="")
        return lib_path
    t0 = time.perf_counter()
    work = BUILD_DIR / f"tmp_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(" ".join(cmd))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
    tmp_lib = work / lib_path.name
    link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
            *[str(obj) for _, obj, _ in procs], "-o", str(tmp_lib)]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs.append(f"$ {' '.join(link)}\n{res.stdout}")
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
    os.replace(tmp_lib, lib_path)  # atomic: a concurrent loader sees all or nothing
    shutil.rmtree(work)
    log = "\n".join(logs)
    (BUILD_DIR / (lib_path.stem + ".log")).write_text(log)
    BUILD_INFO.update(lib=str(lib_path), seconds=time.perf_counter() - t0, built=True, log=log)
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use and then cached."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library()))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_rmsnorm.argtypes = [vp, vp, vp, i64, i32, ctypes.c_float, i32, vp]
    lib.repro_rmsnorm.restype = i32
    lib.repro_paged_attention.argtypes = [vp] * 8 + [i64] + [i32] * 6 + [vp]
    lib.repro_paged_attention.restype = i32
    lib.repro_paged_attention_smem_bytes.argtypes = [i32, i32, i32]
    lib.repro_paged_attention_smem_bytes.restype = i64
    lib.repro_error_string.argtypes = [i32]
    lib.repro_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
