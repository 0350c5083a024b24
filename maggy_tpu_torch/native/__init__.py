"""Native (C++) control-plane codec, loaded via ctypes.

The port's copy of ``maggy_tpu/native/__init__.py``: ``framing.cpp`` (its
own copy in this package) holds SHA-256, HMAC-SHA256, the constant-time
digest compare, the frame scanner the RPC server runs once per frame, the
slice-by-8 crc32c and the whole-buffer TFRecord scanner. It is host code:
nothing in it runs on the card.

The library builds with ``g++ -O2 -shared -fPIC -std=c++17`` at first use
into ``build/native/`` of the checkout, named by the digest of the source,
so an unchanged source is built once per checkout. The build writes a
per-pid temp path and renames it into place with ``os.replace``, so
concurrent runner processes never load a half-written library. Without a
toolchain every entry point falls back to Python (``maggy_tpu/native/
__init__.py:1-6``); the ``py_*`` functions are those fallbacks, exposed so
tests can hold both routes to each other. ``chip_smoke.py`` fails on a
machine where ``is_native()`` is false.
"""

from __future__ import annotations

import ctypes
import hashlib
import hmac as _py_hmac
import os
import subprocess
import threading
from typing import List, Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "framing.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lock = threading.Lock()
_build_attempted = False
#: The last build's compiler output, or the reason there is no library.
build_error: Optional[str] = None


def library_path() -> str:
    """Where the library of the current source lives: one file per source
    digest, so an edited source builds anew."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, "_maggy_native.{}.so".format(digest))


def _build(so: str) -> bool:
    global build_error
    tmp = "{}.tmp.{}".format(so, os.getpid())
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except subprocess.CalledProcessError as e:
        build_error = e.stderr.decode(errors="replace")[-2000:]
    except Exception as e:  # noqa: BLE001 - no toolchain: the Python fallback
        build_error = repr(e)
    try:
        os.unlink(tmp)
    except OSError:
        pass
    return False


def get_lib():
    """The loaded native library, or None (fallback mode)."""
    global _lib, _build_attempted, build_error
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            if _build_attempted:
                return None
            _build_attempted = True
            if not _build(so):
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            build_error = repr(e)
            return None
        lib.maggy_hmac_sha256.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p]
        lib.maggy_hmac_sha256.restype = None
        lib.maggy_digest_eq.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.maggy_digest_eq.restype = ctypes.c_int
        lib.maggy_frame_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_size_t]
        lib.maggy_frame_scan.restype = ctypes.c_long
        lib.maggy_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.maggy_crc32c.restype = ctypes.c_uint32
        lib.maggy_tfrecord_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_long, ctypes.c_int]
        lib.maggy_tfrecord_scan.restype = ctypes.c_long
        _lib = lib
        return _lib


def is_native() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------- Python routes


def py_hmac_sha256(key: bytes, msg: bytes) -> bytes:
    return _py_hmac.new(key, msg, hashlib.sha256).digest()


def py_digest_eq(a: bytes, b: bytes) -> bool:
    return _py_hmac.compare_digest(a, b)


def py_frame_scan(buf, key: bytes, max_frame: int) -> int:
    """``frame_scan`` in Python, the mirror of framing.cpp's."""
    header = 4 + 32
    if len(buf) < header:
        return 0
    length = int.from_bytes(bytes(buf[:4]), "big")
    if length > max_frame:
        return -1
    if len(buf) < header + length:
        return 0
    mac = py_hmac_sha256(key, bytes(buf[header:header + length]))
    if not _py_hmac.compare_digest(mac, bytes(buf[4:header])):
        return -2
    return header + length


# ---------------------------------------------------------- entry points


def hmac_sha256(key: bytes, msg: bytes) -> bytes:
    lib = get_lib()
    if lib is None:
        return py_hmac_sha256(key, msg)
    out = ctypes.create_string_buffer(32)
    lib.maggy_hmac_sha256(key, len(key), msg, len(msg), out)
    return out.raw


def digest_eq(a: bytes, b: bytes) -> bool:
    """Constant-time compare of two digests of equal length."""
    lib = get_lib()
    if lib is None or len(a) != len(b):
        return py_digest_eq(a, b)
    return bool(lib.maggy_digest_eq(a, b, len(a)))


def frame_scan(buf, key: bytes, max_frame: int) -> int:
    """Scan one frame: > 0 the total size consumed (valid), 0 incomplete,
    -1 oversized, -2 bad HMAC."""
    lib = get_lib()
    if lib is None:
        return py_frame_scan(buf, key, max_frame)
    if isinstance(buf, bytearray) and len(buf):
        # A zero-copy view into the connection's reassembly buffer: this runs
        # once per frame on the server's event-loop thread.
        cbuf = (ctypes.c_char * len(buf)).from_buffer(buf)
        return int(lib.maggy_frame_scan(cbuf, len(buf), key, len(key), max_frame))
    return int(lib.maggy_frame_scan(bytes(buf), len(buf), key, len(key), max_frame))


def crc32c(data: bytes) -> Optional[int]:
    """Native crc32c (Castagnoli), or None in fallback mode: the caller
    (``train/tfrecord.py``) owns the Python table."""
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.maggy_crc32c(data, len(data)))


def tfrecord_scan(data: bytes, verify: bool = True) -> Optional[List[Tuple[int, int]]]:
    """(offset, length) of every record payload in a TFRecord buffer, the
    crcs verified natively, or None in fallback mode. Raises ValueError on a
    truncated or corrupt buffer."""
    lib = get_lib()
    if lib is None:
        return None
    # One entry per 16 bytes bounds the count (the least record is 16 bytes).
    cap = max(1, len(data) // 16)
    offs = (ctypes.c_int64 * cap)()
    lens = (ctypes.c_int64 * cap)()
    n = int(lib.maggy_tfrecord_scan(data, len(data), offs, lens, cap, 1 if verify else 0))
    if n == -1:
        raise ValueError("Truncated TFRecord buffer")
    if n == -2:
        raise ValueError("Corrupt TFRecord crc")
    if n < 0:
        raise ValueError("TFRecord scan failed ({})".format(n))
    return [(offs[i], lens[i]) for i in range(n)]
