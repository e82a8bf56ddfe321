"""Build and load the hand-written CUDA kernels.

Each source ``dtc_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and
is one library: ``floquet_x`` (K1/K2), ``floquet_x_resident`` (K3a/K3b,
constant or per-cycle x at 14 <= L <= 21), ``floquet_x_streamed`` (the
large-L x family that replaces K6a/K6b/K7a/K7b), ``floquet_general`` (K4,
K5), ``floquet_general_streamed`` (the large-L lab-frame family,
K10a/K10b, and the per-shard lab-frame cycles, one cycle on a shard's
local bits: K8c/K8d at 17 <= L_loc <= 23, K10's shard-local forms at
22 <= L_loc <= 30), ``floquet_cycle`` (K8a/K8b, one x cycle on a shard's
local bits, 17 <= L_loc <= 23), ``floquet_cycle_hi`` (K9a/K9b, one x cycle on a
shard's local bits, 22 <= L_loc <= 30) and
``noise_factor`` (K11, the planar engine's per-cycle noise factor). A source is
compiled at first use with nvcc for sm_90a into a shared library under
``dtc_tpu_torch/csrc/build/`` (named by the hash of the source, the shared
headers ``csrc/*.cuh`` and the flags, so an edit rebuilds) and loaded with
``ctypes``. This takes seconds; ``torch.utils.cpp_extension.load`` would
compile against PyTorch's headers and take minutes. ``load_all`` starts one
nvcc per library at once. A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
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

_VP, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)

# library -> {C function: argtypes}; every function returns an int (a size,
# or the cudaError of its launches)
LIBRARIES = {
    "floquet_x": {
        "floquet_x_forward_partials": [_I32],
        "floquet_x_echo_partials": [_I32],
        "floquet_x_forward": [_VP, _VP, _VP, _VP, _VP, _I32, _I32, _I32,
                              _I32, _I32, _I64, _F32, _F32, _VP],
        "floquet_x_echo": [_VP, _VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32,
                           _I32, _I32, _I64, _F32, _F32, _VP],
    },
    "floquet_x_resident": {
        "floquet_x_resident_forward_partials": [_I32],
        "floquet_x_resident_echo_partials": [_I32],
        "floquet_x_resident_forward": [_VP, _VP, _VP, _VP, _VP, _VP, _I32,
                                       _I32, _I32, _I32, _I32, _I32, _I64,
                                       _VP],
        "floquet_x_resident_echo": [_VP, _VP, _VP, _VP, _VP, _VP, _I32,
                                    _I32, _I32, _I32, _I32, _I32, _I32, _I64,
                                    _VP],
    },
    "floquet_x_streamed": {
        "floquet_x_streamed_partials": [_I32],
        "floquet_x_streamed_passes": [_I32],
        "floquet_x_streamed_forward": [_VP, _VP, _VP, _VP, _VP, _I32, _I32,
                                       _I32, _I32, _I32, _I32, _I64, _F32,
                                       _F32, _VP],
        "floquet_x_streamed_echo_partials": [_I32],
        "floquet_x_streamed_echo": [_VP, _VP, _VP, _VP, _VP, _I32, _I32,
                                    _I32, _I32, _I32, _I32, _I32, _I64, _F32,
                                    _F32, _VP],
    },
    "floquet_general": {
        "floquet_general_forward_partials": [_I32],
        "floquet_general_echo_partials": [_I32],
        "floquet_general_forward": [_VP, _VP, _VP, _VP, _VP, _I32, _I32,
                                    _I32, _I32, _I32, _I32, _I32, _I64, _VP],
        "floquet_general_echo": [_VP, _VP, _VP, _VP, _VP, _I32, _I32, _I32,
                                 _I32, _I32, _I32, _I64, _VP],
        "floquet_general_observables_slots": [_I32, _I32],
        "floquet_general_observables": [_VP, _VP, _VP, _VP, _VP, _VP, _I32,
                                        _I32, _I32, _I32, _I32, _I32, _I32,
                                        _I32, _I64, _VP],
    },
    "floquet_general_streamed": {
        "floquet_general_streamed_partials": [_I32],
        "floquet_general_streamed_passes": [_I32],
        "floquet_general_streamed_forward": [_VP, _VP, _VP, _VP, _VP, _I32,
                                             _I32, _I32, _I32, _I32, _I32,
                                             _I32, _I64, _VP],
        "floquet_general_streamed_echo_partials": [_I32],
        "floquet_general_streamed_echo": [_VP, _VP, _VP, _VP, _VP, _I32,
                                          _I32, _I32, _I32, _I32, _I32, _I64,
                                          _VP],
        "floquet_cycle_hi_general_forward": [_VP, _VP, _VP, _VP, _VP, _I32,
                                             _I32, _I32, _I32, _I32, _VP],
        "floquet_cycle_hi_general_inverse": [_VP, _VP, _VP, _I32, _I32, _I32,
                                             _I32, _VP],
        "floquet_cycle_general_partials": [_I32],
        "floquet_cycle_general_forward": [_VP, _VP, _VP, _VP, _VP, _I32,
                                          _I32, _I32, _I32, _VP],
        "floquet_cycle_general_inverse": [_VP, _VP, _VP, _I32, _I32, _I32,
                                          _VP],
    },
    "floquet_cycle": {
        "floquet_cycle_partials": [_I32],
        "floquet_cycle_forward": [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _F32,
                                  _F32, _VP],
        "floquet_cycle_inverse": [_VP, _VP, _I32, _I32, _F32, _F32, _VP],
    },
    "floquet_cycle_hi": {
        "floquet_cycle_hi_partials": [_I32],
        "floquet_cycle_hi_forward": [_VP, _VP, _VP, _VP, _I32, _I32, _I32,
                                     _F32, _F32, _VP],
        "floquet_cycle_hi_inverse": [_VP, _VP, _I32, _I32, _F32, _F32, _VP],
    },
    "noise_factor": {
        "noise_factor_apply": [_VP, _VP, _I32, _I32, _VP],
    },
}

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


def _library_path(name: str) -> tuple[str, str]:
    """(source, hash-named library path) of ``csrc/<name>.cu``."""
    src = os.path.join(CSRC, f"{name}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}-{digest.hexdigest()[:16]}.so")


def _open(name: str, so: str, info: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(so)
    for fn, argtypes in LIBRARIES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I32
    _loaded[name] = lib
    build_info[name] = info
    return lib


def load_all(names=None) -> dict[str, ctypes.CDLL]:
    """Build (all nvcc runs at once) and load the named libraries, default
    all of them; raises if any build fails."""
    wanted = list(names or LIBRARIES)
    jobs = []
    for name in (n for n in wanted if n not in _loaded):
        src, so = _library_path(name)
        info = {"path": so, "seconds": 0.0, "log": ""}
        if os.path.exists(so):
            jobs.append((name, so, info, None, None))
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, so, info, proc, (tmp, src, time.perf_counter())))
    failed = []
    for name, so, info, proc, pending in jobs:
        if proc is not None:
            tmp, src, t0 = pending
            info["log"] = proc.communicate()[0]
            info["seconds"] = time.perf_counter() - t0
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed to build {src}:\n{info['log']}")
                continue
            os.replace(tmp, so)
        _open(name, so, info)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {n: _loaded[n] for n in wanted}


def load(name: str) -> ctypes.CDLL:
    """The compiled library of ``csrc/<name>.cu``, built if needed."""
    if name not in _loaded:
        load_all([name])
    return _loaded[name]
