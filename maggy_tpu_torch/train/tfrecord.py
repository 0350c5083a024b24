"""TFRecord + ``tf.train.Example`` reader/writer, dependency-free.

Trimmed copy of ``maggy_tpu/train/tfrecord.py``: the LOCO ablator reads its
study's dataset from a TFRecord of ``tf.train.Example`` rows (reference
``maggy/ablation/ablator/loco.py:41-80``), parsed here without TensorFlow:

- TFRecord framing: ``u64 length ‖ u32 masked-crc32c(length) ‖ payload ‖
  u32 masked-crc32c(payload)``.
- Payload: a ``tf.train.Example`` protobuf, a string-keyed map of
  ``Feature`` values, each one of bytes_list / float_list / int64_list.

The writer emits the same bytes as the JAX package's for the same examples,
so either package reads the other's files. The crc32c and the reader go
through the native codec (``maggy_tpu_torch/native``: slice-by-8 crc32c and
a whole-buffer scanner that verifies every frame in C++, as
``maggy_tpu/train/tfrecord.py:43, 259`` do), with the Python table loop as
the fallback where no toolchain built it.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

# ------------------------------------------------------------------ crc32c

_CRC32C_POLY = 0x82F63B78
_CRC32C_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ _CRC32C_POLY if _c & 1 else _c >> 1
    _CRC32C_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``: the native slice-by-8 route, or one
    table lookup a byte where the codec is not built."""
    from maggy_tpu_torch import native

    value = native.crc32c(bytes(data))
    if value is not None:
        return value
    return py_crc32c(data)


def py_crc32c(data: bytes) -> int:
    """The table loop of ``crc32c``."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TFRecord's rotated+offset crc mask (tensorflow/core/lib/hash/crc32c.h)."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf wire fmt

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


# ------------------------------------------------------------- Example enc

def _encode_feature(values) -> bytes:
    """One ``Feature``: bytes -> bytes_list(1), float -> float_list(2),
    int -> int64_list(3); lists stay lists."""
    if isinstance(values, (bytes, str, int, float, np.integer, np.floating)):
        values = [values]
    values = list(values)
    if not values:
        return _len_delim(3, b"")  # empty int64_list
    if all(isinstance(v, (bytes, str)) for v in values):
        inner = b"".join(
            _len_delim(1, v.encode() if isinstance(v, str) else bytes(v))
            for v in values)
        return _len_delim(1, inner)
    # A single float promotes the whole list: dispatching on the first
    # element alone would silently int()-truncate [1, 2.5] -> [1, 2].
    if all(isinstance(v, (int, float, np.integer, np.floating, bool,
                          np.bool_)) for v in values):
        if any(isinstance(v, (float, np.floating)) for v in values):
            inner = _tag(1, 2) + _varint(4 * len(values)) + struct.pack(
                "<{}f".format(len(values)), *[float(v) for v in values])
            return _len_delim(2, inner)
        packed = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in values)
        inner = _tag(1, 2) + _varint(len(packed)) + packed
        return _len_delim(3, inner)
    raise TypeError(
        "Unsupported or mixed feature value types {}".format(
            sorted({type(v).__name__ for v in values})))


def encode_example(features: Dict[str, Any]) -> bytes:
    """``dict`` -> serialized ``tf.train.Example``."""
    entries = b""
    for name, values in features.items():
        feature = _encode_feature(values)
        entry = _len_delim(1, name.encode()) + _len_delim(2, feature)
        entries += _len_delim(1, entry)  # Features.feature map entry
    return _len_delim(1, entries)  # Example.features


def _decode_packed_or_repeated(buf: bytes, scalar_wire: int):
    """Values of a {Bytes,Float,Int64}List's field 1, handling both packed
    (one LEN record) and unpacked (repeated scalar records) encodings."""
    out: List[Any] = []
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if field != 1:
            pos = _skip(buf, pos, wire)
            continue
        if wire == 2 and scalar_wire == 5:  # packed floats
            ln, pos = _read_varint(buf, pos)
            out.extend(struct.unpack("<{}f".format(ln // 4),
                                     buf[pos:pos + ln]))
            pos += ln
        elif wire == 2 and scalar_wire == 0:  # packed varints
            ln, pos = _read_varint(buf, pos)
            end = pos + ln
            while pos < end:
                v, pos = _read_varint(buf, pos)
                out.append(v - (1 << 64) if v >= (1 << 63) else v)
        elif wire == 2:  # bytes element
            ln, pos = _read_varint(buf, pos)
            out.append(buf[pos:pos + ln])
            pos += ln
        elif wire == 5:  # unpacked float
            out.append(struct.unpack("<f", buf[pos:pos + 4])[0])
            pos += 4
        elif wire == 0:  # unpacked varint
            v, pos = _read_varint(buf, pos)
            out.append(v - (1 << 64) if v >= (1 << 63) else v)
        else:
            pos = _skip(buf, pos, wire)
    return out


def _skip(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        ln, pos = _read_varint(buf, pos)
        pos += ln
    elif wire == 5:
        pos += 4
    else:
        raise ValueError("Unsupported wire type {}".format(wire))
    return pos


def _submessages(buf: bytes, want_field: int):
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if field == want_field and wire == 2:
            ln, pos = _read_varint(buf, pos)
            yield buf[pos:pos + ln]
            pos += ln
        else:
            pos = _skip(buf, pos, wire)


def decode_example(raw: bytes) -> Dict[str, List[Any]]:
    """Serialized ``tf.train.Example`` -> ``{name: [values...]}``."""
    out: Dict[str, List[Any]] = {}
    for features in _submessages(raw, 1):  # Example.features
        for entry in _submessages(features, 1):  # map entries
            name = None
            values: List[Any] = []
            pos = 0
            while pos < len(entry):
                key, pos = _read_varint(entry, pos)
                field, wire = key >> 3, key & 7
                if field == 1 and wire == 2:  # key
                    ln, pos = _read_varint(entry, pos)
                    name = entry[pos:pos + ln].decode()
                    pos += ln
                elif field == 2 and wire == 2:  # Feature
                    ln, pos = _read_varint(entry, pos)
                    feature = entry[pos:pos + ln]
                    pos += ln
                    for kind, scalar_wire in ((1, 2), (2, 5), (3, 0)):
                        for lst in _submessages(feature, kind):
                            values = _decode_packed_or_repeated(
                                lst, scalar_wire)
                else:
                    pos = _skip(entry, pos, wire)
            if name is not None:
                out[name] = values
    return out


# ------------------------------------------------------------ file framing

def frame_record(payload: bytes) -> bytes:
    """One TFRecord frame: ``u64 length ‖ u32 masked-crc32c(length) ‖
    payload ‖ u32 masked-crc32c(payload)``."""
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload
            + struct.pack("<I", _masked_crc(payload)))


def write_tfrecord(path: str, examples) -> None:
    """Write ``examples`` (dicts of feature values) as a TFRecord file."""
    with open(path, "wb") as f:
        for ex in examples:
            f.write(frame_record(ex if isinstance(ex, bytes) else encode_example(ex)))


# The whole-buffer scan holds the file and about its size again of index
# arrays; past this size the streaming loop (whose crcs still go native)
# keeps peak memory bounded (``maggy_tpu/train/tfrecord.py:245-248``).
_NATIVE_SCAN_MAX_BYTES = 256 * 1024 * 1024


def iter_tfrecord(path: str, verify: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file, each frame's crcs
    verified unless ``verify`` is False. A file up to
    ``_NATIVE_SCAN_MAX_BYTES`` goes through the native whole-buffer scanner
    (crcs verified in C++); a larger one, or any file without the codec,
    streams record by record with bounded memory."""
    from maggy_tpu_torch import native

    if os.path.getsize(path) <= _NATIVE_SCAN_MAX_BYTES and native.is_native():
        with open(path, "rb") as f:
            data = f.read()
        try:
            spans = native.tfrecord_scan(data, verify=verify)
        except ValueError as e:
            raise ValueError("{} in {}".format(e, path)) from e
        for off, ln in spans:
            yield data[off:off + ln]
        return
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) < 8:
                raise ValueError("Truncated TFRecord header in {}".format(path))
            (length,) = struct.unpack("<Q", header)
            crc_bytes = f.read(4)
            if len(crc_bytes) < 4:
                raise ValueError("Truncated TFRecord length crc in {}".format(path))
            (length_crc,) = struct.unpack("<I", crc_bytes)
            if verify and length_crc != _masked_crc(header):
                raise ValueError("Corrupt TFRecord length crc in {}".format(path))
            payload = f.read(length)
            if len(payload) < length:
                raise ValueError("Truncated TFRecord payload in {}".format(path))
            crc_bytes = f.read(4)
            if len(crc_bytes) < 4:
                raise ValueError("Truncated TFRecord payload crc in {}".format(path))
            (payload_crc,) = struct.unpack("<I", crc_bytes)
            if verify and payload_crc != _masked_crc(payload):
                raise ValueError("Corrupt TFRecord payload crc in {}".format(path))
            yield payload


def load_tfrecord_dataset(paths, columns: Optional[list] = None) -> Dict[str, np.ndarray]:
    """Read TFRecord file(s) of ``tf.train.Example`` into a dict of stacked
    numpy arrays — the dict-of-arrays shape every data path of the package
    (``ShardedBatchIterator``, LOCO's ``drop_feature``) consumes.

    Scalar features stack to shape ``(N,)``; fixed-length list features to
    ``(N, k)``. Ragged features raise (pad upstream). int64 lists become
    int64 arrays, float lists float32, bytes lists object arrays of bytes.
    """
    if isinstance(paths, str):
        paths = [paths]
    rows: List[Dict[str, List[Any]]] = []
    for path in paths:
        for payload in iter_tfrecord(path):
            ex = decode_example(payload)
            if columns is not None:
                missing = set(columns) - set(ex)
                if missing:
                    raise KeyError(
                        "TFRecord example in {} lacks column(s) {}".format(
                            path, sorted(missing)))
                ex = {k: ex[k] for k in columns}
            rows.append(ex)
    if not rows:
        raise ValueError("No records in {}".format(paths))
    names = set(rows[0])
    for i, r in enumerate(rows):
        if set(r) != names:
            raise ValueError(
                "Inconsistent TFRecord schema at record {} (have {}, "
                "expected {})".format(i, sorted(r), sorted(names)))
    out: Dict[str, np.ndarray] = {}
    for name in sorted(names):
        lengths = {len(r[name]) for r in rows}
        if len(lengths) != 1:
            raise ValueError(
                "Ragged TFRecord feature {!r} (lengths {}); pad before "
                "writing".format(name, sorted(lengths)))
        (k,) = lengths
        if k == 0:
            # A feature empty in every record (legal Example encoding, and
            # write_tfrecord emits it for []): zero-width column.
            out[name] = np.zeros((len(rows), 0), dtype=np.float32)
            continue
        values = [r[name][0] if k == 1 else r[name] for r in rows]
        if values and isinstance(
                (values[0] if k == 1 else values[0][0]), bytes):
            out[name] = np.asarray(values, dtype=object)
        else:
            arr = np.asarray(values)
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)  # proto floats are f32
            out[name] = arr
    return out


def is_tfrecord_path(path: str) -> bool:
    if path.endswith((".tfrecord", ".tfrecords")):
        return True
    return os.path.isdir(path) and any(
        f.endswith((".tfrecord", ".tfrecords")) for f in os.listdir(path))
