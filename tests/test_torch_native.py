"""The port's native codec (``maggy_tpu_torch/native``, its own copy of
framing.cpp built into ``build/native/``) against the JAX package's codec and
Python on the CPU: HMAC-SHA256, the constant-time digest compare, the frame
scanner (valid, partial, bad MAC, oversized, two frames, fuzz), crc32c and
the TFRecord scanner, a TFRecord written by the JAX writer, and the Python
fallback route. Every comparison is exact."""

import hashlib
import hmac
import os
import socket
import struct

import numpy as np
import pytest

from maggy_tpu import native as jax_native
from maggy_tpu.train import tfrecord as jax_tfrecord

from maggy_tpu_torch import native
from maggy_tpu_torch.core import rpc
from maggy_tpu_torch.train import tfrecord

pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]

MAX = 1 << 20


def frame(payload: bytes, key: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + hmac.new(key, payload, hashlib.sha256).digest() \
        + payload


def scans(buf, key, max_frame=MAX):
    """(port native, port Python, JAX codec) results of one scan."""
    return (native.frame_scan(buf, key, max_frame), native.py_frame_scan(buf, key, max_frame),
            jax_native.frame_scan(bytes(buf), key, max_frame))


def test_the_port_builds_its_own_copy_into_build_native():
    assert native.is_native(), native.build_error
    path = native.library_path()
    assert os.path.dirname(path).endswith(os.path.join("build", "native"))
    assert os.path.exists(path) and native.SRC.startswith(os.path.dirname(native.__file__))
    with open(native.SRC) as a, open(jax_native._SRC) as b:
        # The copy differs from the JAX package's only in its header comment.
        body = [line for line in a.read().splitlines() if not line.startswith("//")]
        assert body == [line for line in b.read().splitlines() if not line.startswith("//")]


@pytest.mark.parametrize("key,msg", [(b"k", b""), (b"secret-key", b"hello world"),
                                     (b"x" * 64, b"y" * 1000), (b"long-key" * 20, b"payload")])
def test_hmac_equals_hashlib_and_the_jax_codec(key, msg):
    want = hmac.new(key, msg, hashlib.sha256).digest()
    assert native.hmac_sha256(key, msg) == native.py_hmac_sha256(key, msg) == want
    assert jax_native.hmac_sha256(key, msg) == want
    assert rpc._sign(key, msg) == want


def test_digest_compare_is_exact():
    a = hashlib.sha256(b"a").digest()
    b = bytearray(a)
    b[-1] ^= 1
    assert native.digest_eq(a, a) and native.py_digest_eq(a, a)
    assert not native.digest_eq(a, bytes(b)) and not native.py_digest_eq(a, bytes(b))
    assert not native.digest_eq(a, a[:16])


@pytest.mark.parametrize("case", ["valid", "partial", "bad_mac", "oversized", "two_frames",
                                  "empty"])
def test_frame_scan_equals_the_jax_codec_and_python(case):
    key = b"s3cret"
    one, two = frame(b'{"type": "REG"}', key), frame(b"second", key)
    if case == "valid":
        buf, want = bytearray(one), len(one)
    elif case == "partial":
        for cut in (0, 10, 36, len(one) - 1):
            assert scans(bytearray(one[:cut]), key) == (0, 0, 0)
        return
    elif case == "bad_mac":
        buf = bytearray(one)
        buf[10] ^= 0xFF
        want = -2
    elif case == "oversized":
        buf, want = bytearray(struct.pack(">I", 1 << 30) + b"\x00" * 32), -1
    elif case == "two_frames":
        buf = bytearray(one + two)
        assert scans(buf, key) == (len(one),) * 3
        assert scans(buf[len(one):], key) == (len(two),) * 3
        return
    else:
        buf, want = bytearray(), 0
    assert scans(buf, key) == (want,) * 3
    assert scans(bytes(buf), key) == (want,) * 3


def test_frame_scan_fuzz_agrees_everywhere():
    rng = np.random.default_rng(0)
    key = b"fuzz"
    for _ in range(400):
        n = int(rng.integers(0, 200))
        buf = bytearray(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        if n >= 4 and rng.random() < 0.5:
            buf[:4] = struct.pack(">I", int(rng.integers(0, 300)))
        if rng.random() < 0.2:
            buf = bytearray(frame(bytes(buf), key))
        got = scans(buf, key, 256)
        assert got[0] == got[1] == got[2], (bytes(buf), got)


def test_the_server_reads_port_frames_through_the_codec():
    """The port's frames (length || HMAC || JSON) pass the codec's scan as
    they are: the server answers a signed QUERY and drops a frame under
    another secret."""
    server = rpc.OptimizationServer(num_executors=1)
    addr = server.start()
    try:
        sock = socket.create_connection(addr, timeout=5)
        rpc.MessageSocket.send_msg(sock, {"type": "QUERY"}, server.secret)
        assert rpc.MessageSocket.recv_msg(sock, server.secret) == {"type": "QUERY",
                                                                   "done": False}
        payload = rpc._encode({"type": "QUERY"})
        wire = frame(payload, server.secret)
        assert native.frame_scan(bytearray(wire), server.secret, rpc.MAX_FRAME) == len(wire)
        rpc.MessageSocket.send_msg(sock, {"type": "QUERY"}, b"not the secret")
        with pytest.raises((ConnectionError, OSError)):
            rpc.MessageSocket.recv_msg(sock, server.secret)
        sock.close()
    finally:
        server.stop()


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 64, 1000, 4099])
def test_crc32c_equals_the_table_and_the_jax_codec(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert tfrecord.crc32c(data) == tfrecord.py_crc32c(data) == native.crc32c(data) \
        == jax_native.crc32c(data) == jax_tfrecord.crc32c(data)
    assert tfrecord.py_crc32c(b"123456789") == 0xE3069283


def test_tfrecord_scan_reads_the_jax_writers_file(tmp_path):
    path = str(tmp_path / "jax.tfrecord")
    rows = [{"a": float(i) / 3, "b": i, "s": b"x" * i} for i in range(40)]
    jax_tfrecord.write_tfrecord(path, rows)
    data = open(path, "rb").read()
    spans = native.tfrecord_scan(data)
    assert spans == jax_native.tfrecord_scan(data)
    assert [data[o:o + n] for o, n in spans] == list(jax_tfrecord.iter_tfrecord(path))
    assert list(tfrecord.iter_tfrecord(path)) == list(jax_tfrecord.iter_tfrecord(path))
    port_path = str(tmp_path / "port.tfrecord")
    tfrecord.write_tfrecord(port_path, rows)
    assert open(port_path, "rb").read() == data


def test_tfrecord_scan_refuses_corruption_and_truncation(tmp_path):
    path = str(tmp_path / "r.tfrecord")
    tfrecord.write_tfrecord(path, [{"v": i} for i in range(5)])
    data = bytearray(open(path, "rb").read())
    with pytest.raises(ValueError, match="Truncated"):
        native.tfrecord_scan(bytes(data[:-3]))
    data[14] ^= 0xFF
    with pytest.raises(ValueError, match="Corrupt"):
        native.tfrecord_scan(bytes(data))
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="Corrupt"):
        list(tfrecord.iter_tfrecord(path))


def test_the_fallback_route_agrees(tmp_path, monkeypatch):
    """Without the library every entry point takes the Python route and
    gives the same answers."""
    key, msg = b"key", b"message"
    data = np.random.default_rng(1).integers(0, 256, 999, dtype=np.uint8).tobytes()
    path = str(tmp_path / "f.tfrecord")
    tfrecord.write_tfrecord(path, [{"v": i} for i in range(7)])
    native_out = (native.hmac_sha256(key, msg), native.frame_scan(frame(msg, key), key, MAX),
                  tfrecord.crc32c(data), list(tfrecord.iter_tfrecord(path)))
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert not native.is_native()
    assert native.crc32c(data) is None and native.tfrecord_scan(open(path, "rb").read()) is None
    fallback = (native.hmac_sha256(key, msg), native.frame_scan(frame(msg, key), key, MAX),
                tfrecord.crc32c(data), list(tfrecord.iter_tfrecord(path)))
    assert fallback == native_out
