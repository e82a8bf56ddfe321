"""Build and load the hand-written CUDA kernels.

The sources under ``dtc_tpu_torch/csrc/`` expose a plain C interface; they
are compiled at first use with nvcc for sm_90a into a shared library under
``dtc_tpu_torch/csrc/build/`` (named by the hash of source and flags, so an
edited source rebuilds) and loaded with ``ctypes``. This takes seconds;
``torch.utils.cpp_extension.load`` would compile against PyTorch's headers
and take minutes. A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else PATH, else the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.sep, "usr", "local", "cuda", "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)
    lib.floquet_x_forward_partials.argtypes = [i32]
    lib.floquet_x_forward_partials.restype = i32
    lib.floquet_x_echo_partials.argtypes = [i32]
    lib.floquet_x_echo_partials.restype = i32
    lib.floquet_x_forward.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i64,
                                      f32, f32, vp]
    lib.floquet_x_forward.restype = i32
    lib.floquet_x_echo.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32,
                                   i64, f32, f32, vp]
    lib.floquet_x_echo.restype = i32


def load(name: str = "floquet_x") -> ctypes.CDLL:
    """The compiled library of ``csrc/<name>.cu``, built if needed."""
    if name in _loaded:
        return _loaded[name]
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    info = {"path": so, "seconds": 0.0, "log": ""}
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed to build {src}:\n{info['log']}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    _declare(lib)
    _loaded[name] = lib
    build_info[name] = info
    return lib
