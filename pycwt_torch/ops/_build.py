"""Build and load the port's CUDA sources at first use.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, under ``pycwt_torch/_build/``
(listed in ``.gitignore``), and loaded with ``ctypes``.  The library's file
name carries a hash of its source, the shared headers ``csrc/*.cuh`` and the
flags, so an edited source or header rebuilds and an unchanged one loads at
once.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["build_all", "library", "set_build_dir", "BUILD_DIR"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
#: Where libraries are built and looked up; :func:`set_build_dir` moves it
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

#: library name -> its CUDA source in csrc/
SOURCES = {"fused_cwt": "fused_cwt.cu", "direct_cwt": "direct_cwt.cu",
           "mc_noise": "mc_noise.cu", "mc_hist": "mc_hist.cu", "wct_head": "wct_head.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_V, _I, _LL, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float, ctypes.c_double)

#: C signatures: function -> (argtypes, restype); cudaError_t is an int.
_SIGNATURES = {
    "fused_cwt": {
        "cwt_stage_a": ([_V, _V, _LL, _V, _V, _V, _I, _I, _I, _I, _I, _I,
                         _I, _F, _I, _F, _F, _F, _F, _I, _I, _I, _I, _V], _I),
        "cwt_stage_b": ([_V, _V, _V, _V, _LL, _I, _I, _I, _I, _F,
                         _I, _I, _I, _I, _V], _I),
        # the same entries with a bf16 T (precision="fast")
        "cwt_stage_a_bf16": ([_V, _V, _LL, _V, _V, _V, _I, _I, _I, _I, _I, _I,
                              _I, _F, _I, _F, _F, _F, _F, _I, _I, _I, _I, _V], _I),
        "cwt_stage_b_bf16": ([_V, _V, _V, _V, _LL, _I, _I, _I, _I, _F,
                              _I, _I, _I, _I, _V], _I),
        "cwt_stage_b_ablation": ([_V, _V, _V, _V, _LL, _I, _I, _I, _F,
                                  _I, _I, _I, _I, _I, _V], _I),
    },
    "direct_cwt": {
        "cwt_direct": ([_V, _V, _LL, _V, _V, _V, _I, _I, _I, _I, _I, _F,
                        _I, _F, _F, _F, _F, _I, _I, _I, _I, _V], _I),
    },
    "mc_noise": {
        "mc_fold_in": ([_V, _V, _V, _LL, _V, _V, _V], _I),
        "mc_rednoise_f32": ([_V, _V, _V, _V, _I, _I, _I, _I, _D, _V, _D, _D,
                             _D, _I, _V, _V], _I),
        "mc_rednoise_f64": ([_V, _V, _V, _V, _I, _I, _I, _I, _D, _V, _D, _D,
                             _D, _I, _V, _V], _I),
    },
    "mc_hist": {
        "mc_coherence_counts": ([_V, _V, _V, _V, _LL, _I, _I, _I, _I, _V], _I),
    },
    "wct_head": {
        "wct_fields_head": ([_V, _V, _V, _V, _V, _V, _V, _V, _V, _LL, _I, _I, _LL, _LL, _LL,
                             _V], _I),
    },
}

_LOADED: dict[str, ctypes.CDLL] = {}
#: name -> (seconds, nvcc output) of builds made by this process
BUILD_LOG: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def set_build_dir(path: str) -> None:
    """Build into, and load from, ``path`` from now on.  A library already
    loaded in this process stays the one loaded."""
    global BUILD_DIR
    BUILD_DIR = os.path.abspath(path)


def _target(name: str, csrc_dir: str = CSRC_DIR) -> str:
    """The library's path: its name and a hash of its source, of every
    header in ``csrc_dir`` (``*.cuh``, which any source may include) and of
    the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(csrc_dir) if f.endswith(".cuh"))
    for fname in [SOURCES[name], *headers]:
        with open(os.path.join(csrc_dir, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all(names=None) -> dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together.  Returns name -> library path; raises
    ``RuntimeError`` with the compiler's output if a build fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: _target(name) for name in names}
    running = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, time.perf_counter())
    for name, (proc, tmp, t0) in running.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{out}")
        os.replace(tmp, paths[name])
        BUILD_LOG[name] = (time.perf_counter() - t0, out)
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with every
    function's ``argtypes`` and ``restype`` set."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_all([name])[name])
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LOADED[name] = lib
    return lib
