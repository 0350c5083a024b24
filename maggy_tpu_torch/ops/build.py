"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source in ``ops/csrc/`` compiles on first use into ``build/kernels/``
of the checkout, named by the hash of its source, so an unchanged source is
built once per checkout. The library has a plain C interface: every kernel
entry takes raw device pointers, shapes, and the CUDA stream, and returns the
``cudaError_t`` of its launch. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signatures of every exported entry point, by source file.
SIGNATURES = {
    "flash_attn.cu": {
        "flash_fwd": [_P, _P, _P, _P, _P, _P] + [_I] * 8 + [_F, _P],
        "flash_bwd_dkdv": [_P] * 9 + [_I] * 8 + [_I, _F, _P],
        "flash_bwd_dq": [_P] * 10 + [_I] * 8 + [_I, _F, _P],
        "flash_kernel_info": [_I] * 4 + [_P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's -Xptxas -v report (registers, shared memory, spills) per source.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that runs them")


def compile_source(name: str) -> str:
    """Compile ``csrc/<name>`` into the build directory (once per source
    hash) and return the library path. Raises on a compiler error."""
    src = os.path.join(CSRC, name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, "{}.{}.so".format(os.path.splitext(name)[0], digest))
    if os.path.exists(lib):
        return lib
    tmp = "{}.tmp.{}".format(lib, os.getpid())
    proc = subprocess.run([_nvcc()] + NVCC_FLAGS + ["-o", tmp, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    build_logs[name] = proc.stdout
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for {}:\n{}".format(name, proc.stdout))
    os.replace(tmp, lib)
    return lib


def compile_all() -> List[str]:
    """Build every source at once, one nvcc process each (used to start all
    builds together before the first kernel call)."""
    names = sorted(SIGNATURES)
    errors: List[BaseException] = []

    def run(n):
        try:
            compile_source(n)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return names


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>``, building it on first use,
    with argtypes/restype set for every entry point."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(compile_source(name))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib
