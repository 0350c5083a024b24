"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source in ``ops/csrc/`` compiles on first use into ``build/kernels/``
of the checkout, named by the hash of its source and flags, so an unchanged
source is built once per checkout. A source with variants (``VARIANTS``)
compiles once per variant, each with its own defines into a library of its
own: ``flash_attn.cu`` once per kernel width and once split over D. The
library has a plain C interface: every kernel entry takes raw device
pointers, shapes, and the CUDA stream, and returns the ``cudaError_t`` of
its launch. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

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

#: The builds of a source that has more than one, by variant name: nvcc
#: defines of each. flash_attn.cu compiles once per kernel width, every
#: multiple of 16 from 64 to 256, and once more as the split-D kernels,
#: which take every head dim above 256 (``ops/attention.py`` kernel_build
#: maps a head dim to its build), so the builds run in parallel and a head
#: dim loads only its own library.
VARIANTS = {"flash_attn.cu": {**{"w{}".format(w): ["-DFLASH_W={}".format(w)]
                                 for w in range(64, 257, 16)},
                              "split": ["-DFLASH_SPLIT"]}}

_lock = threading.Lock()
_libs: Dict[Tuple[str, Optional[str]], ctypes.CDLL] = {}
#: nvcc's -Xptxas -v report (registers, shared memory, spills) per build,
#: keyed by ``build_name``.
build_logs: Dict[str, str] = {}
#: nvcc's wall seconds per build, keyed by ``build_name``.
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that runs them")


def build_name(name: str, variant: Optional[str] = None) -> str:
    """``name``, or ``name:variant`` for a variant build."""
    return name if variant is None else "{}:{}".format(name, variant)


def builds() -> List[Tuple[str, Optional[str]]]:
    """Every (source, variant) build, variant None for a source without
    variants."""
    return [(name, variant) for name in sorted(SIGNATURES)
            for variant in (list(VARIANTS[name]) if name in VARIANTS else [None])]


def _defines(name: str, variant: Optional[str]) -> List[str]:
    if (variant is None) != (name not in VARIANTS):
        raise ValueError("{} builds as {}, not variant {!r}".format(
            name, sorted(VARIANTS[name]) if name in VARIANTS else "itself", variant))
    return [] if variant is None else VARIANTS[name][variant]


def compile_source(name: str, variant: Optional[str] = None) -> str:
    """Compile ``csrc/<name>`` (with ``variant``'s defines) into the build
    directory, once per hash of source and flags, and return the library
    path. Raises on a compiler error."""
    flags = NVCC_FLAGS + _defines(name, variant)
    src = os.path.join(CSRC, name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.splitext(name)[0] + ("" if variant is None else "_" + variant)
    lib = os.path.join(BUILD_DIR, "{}.{}.so".format(stem, digest))
    if os.path.exists(lib):
        return lib
    tmp = "{}.tmp.{}".format(lib, os.getpid())
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc()] + flags + ["-o", tmp, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    key = build_name(name, variant)
    build_seconds[key] = time.perf_counter() - t0
    build_logs[key] = proc.stdout
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for {}:\n{}".format(key, proc.stdout))
    os.replace(tmp, lib)
    return lib


def compile_all() -> List[Tuple[str, Optional[str]]]:
    """Run every build at once, one nvcc process each (used to start all
    builds together before the first kernel call); returns ``builds()``."""
    todo = builds()
    errors: List[BaseException] = []

    def run(name, variant):
        try:
            compile_source(name, variant)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=b) for b in todo]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return todo


def library(name: str, variant: Optional[str] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>`` (its ``variant`` build),
    building it on first use, with argtypes/restype set for every entry
    point."""
    with _lock:
        lib = _libs.get((name, variant))
        if lib is None:
            lib = ctypes.CDLL(compile_source(name, variant))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[(name, variant)] = lib
        return lib
