"""The port's TFRecord codec, dataset registry and path loaders against
maggy_tpu's, on the CPU.

Counterparts of ``tests/test_tfrecord.py`` and ``tests/test_registry.py``:
crc32c vectors; the two writers' files byte for byte; each package reading
the other's files; corrupt and truncated frames refused by both; each format through both ``load_path_dataset``s; a registry
written by one package read by the other (the same manifests); registry
URIs through the loader and ``ShardedBatchIterator.from_path``; concurrent
auto-versioning that never drops a writer. Every value is exact: both
packages store float32 and int64 the same way.
"""

import os
import threading

import numpy as np
import pytest

from maggy_tpu.core.environment import EnvSing as JaxEnvSing
from maggy_tpu.core.environment.abstractenvironment import LocalEnv as JaxLocalEnv
from maggy_tpu.train import data as jax_data
from maggy_tpu.train import registry as jax_registry
from maggy_tpu.train import tfrecord as jax_tfrecord

from maggy_tpu_torch.core.environment import EnvSing
from maggy_tpu_torch.core.environment.abstractenvironment import LocalEnv
from maggy_tpu_torch.train import ShardedBatchIterator, data, registry, tfrecord

pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]

ROWS = 24


@pytest.fixture(autouse=True)
def envs(tmp_path):
    EnvSing.set_instance(LocalEnv(base_dir=str(tmp_path / "port")))
    JaxEnvSing.set_instance(JaxLocalEnv(base_dir=str(tmp_path / "jax")))
    yield
    EnvSing.reset()
    JaxEnvSing.reset()


def _examples(n=ROWS, seed=0):
    """Rows of every Feature kind: float and int scalars, a fixed-length
    float list, bytes, a negative int and an empty list."""
    rng = np.random.default_rng(seed)
    return [{"x": float(rng.normal()), "k": int(rng.integers(-5, 5)),
             "v": [float(a) for a in rng.normal(size=3)], "s": "row{}".format(i).encode(),
             "big": -(2 ** 40) + i, "none": []} for i in range(n)]


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("payload, crc", [(b"", 0x0), (b"123456789", 0xE3069283),
                                          (bytes(32), 0x8A9136AA), (b"\xff" * 32, 0x62A8AB43)])
def test_crc32c_vectors(payload, crc):
    """The iSCSI test vectors (RFC 3720 B.4), and the JAX package's value."""
    assert tfrecord.crc32c(payload) == crc == jax_tfrecord.crc32c(payload)


def test_crc32c_and_example_codec_match_jax_on_random_bytes():
    rng = np.random.default_rng(1)
    for n in (1, 7, 100, 1000):
        blob = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tfrecord.crc32c(blob) == jax_tfrecord.crc32c(blob)
    for ex in _examples(4):
        raw = tfrecord.encode_example(ex)
        assert raw == jax_tfrecord.encode_example(ex)
        assert tfrecord.decode_example(raw) == jax_tfrecord.decode_example(raw)


def test_the_two_writers_give_byte_identical_files(tmp_path):
    ours, theirs = str(tmp_path / "port.tfrecord"), str(tmp_path / "jax.tfrecord")
    tfrecord.write_tfrecord(ours, _examples())
    jax_tfrecord.write_tfrecord(theirs, _examples())
    assert open(ours, "rb").read() == open(theirs, "rb").read()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_files(tmp_path, writer):
    path = str(tmp_path / "d.tfrecord")
    (tfrecord if writer == "port" else jax_tfrecord).write_tfrecord(path, _examples())
    ours = tfrecord.load_tfrecord_dataset(path)
    _same(ours, jax_tfrecord.load_tfrecord_dataset(path))
    assert ours["v"].shape == (ROWS, 3) and ours["none"].shape == (ROWS, 0)
    assert ours["s"][3] == b"row3" and ours["big"].dtype == np.int64
    assert list(tfrecord.iter_tfrecord(path)) == list(jax_tfrecord.iter_tfrecord(path))


def _corrupt(raw):
    raw = bytearray(raw)
    raw[20] ^= 0x01  # inside the first record's payload
    return bytes(raw)


@pytest.mark.parametrize("mutate, message", [
    (_corrupt, "Corrupt TFRecord payload crc"),
    (lambda raw: raw[:6], "Truncated TFRecord header"),
    (lambda raw: raw[:10], "Truncated TFRecord length crc"),
    (lambda raw: raw[:30], "Truncated TFRecord payload"),
    (lambda raw: bytes([raw[0] ^ 1]) + raw[1:], "Corrupt TFRecord length crc"),
])
def test_corrupt_and_truncated_files_are_refused_as_jax(tmp_path, monkeypatch, mutate, message):
    """Both packages read a file this size through their native scanners
    and refuse it with the same words; without the codec the port's
    streaming reader names the frame part at fault (the JAX package's
    streaming reader's words)."""
    from maggy_tpu_torch import native

    path = str(tmp_path / "bad.tfrecord")
    tfrecord.write_tfrecord(path, _examples(2))
    raw = open(path, "rb").read()
    open(path, "wb").write(mutate(raw))
    with pytest.raises(ValueError, match="TFRecord") as port_err:
        list(tfrecord.iter_tfrecord(path))
    with pytest.raises(ValueError, match="TFRecord") as jax_err:
        list(jax_tfrecord.iter_tfrecord(path))
    assert str(port_err.value) == str(jax_err.value)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(ValueError, match=message):
        list(tfrecord.iter_tfrecord(path))


def _formats(tmp_path):
    """One dataset as .npz, .tfrecord, a dir of 4 .tfrecord files and a
    .parquet file (pyarrow is imported only for the last)."""
    rng = np.random.default_rng(2)
    cols = {"a": rng.normal(size=ROWS).astype(np.float32),
            "b": rng.integers(0, 9, ROWS).astype(np.int64)}
    rows = [{"a": float(cols["a"][i]), "b": int(cols["b"][i])} for i in range(ROWS)]
    npz = str(tmp_path / "d.npz")
    np.savez(npz, **cols)
    one = str(tmp_path / "d.tfrecord")
    tfrecord.write_tfrecord(one, rows)
    shard_dir = tmp_path / "shards"
    shard_dir.mkdir()
    for i in range(4):
        tfrecord.write_tfrecord(str(shard_dir / "part{}.tfrecord".format(i)), rows[i::4])
    return cols, {"npz": npz, "tfrecord": one, "dir": str(shard_dir)}


@pytest.mark.parametrize("fmt, shard", [("npz", None), ("tfrecord", None), ("dir", None),
                                        ("dir", (1, 2)), ("parquet", None)])
def test_load_path_dataset_matches_jax(tmp_path, fmt, shard):
    cols, paths = _formats(tmp_path)
    if fmt == "parquet":
        pq = pytest.importorskip("pyarrow.parquet")
        import pyarrow as pa

        paths["parquet"] = str(tmp_path / "d.parquet")
        pq.write_table(pa.table(cols), paths["parquet"])
    ours = data.load_path_dataset(paths[fmt], file_shard=shard)
    _same(ours, jax_data.load_path_dataset(paths[fmt], file_shard=shard))
    assert len(ours["a"]) == (ROWS // 2 if shard else ROWS)
    with pytest.raises(ValueError, match="file-level sharding"):
        data.load_path_dataset(paths["tfrecord"], file_shard=(0, 2))
    with pytest.raises(ValueError, match="5 shards but only 4 tfrecord files"):
        data.load_path_dataset(paths["dir"], file_shard=(0, 5))


def test_a_registry_written_by_either_package_is_read_by_the_other(tmp_path):
    _, paths = _formats(tmp_path)
    root = str(tmp_path / "reg")
    ours, theirs = registry.DatasetRegistry(root=root), jax_registry.DatasetRegistry(root=root)
    assert ours.register("toy", paths["tfrecord"], description="port") == 1
    assert theirs.register("toy", paths["npz"]) == 2
    assert ours.register("toy", paths["dir"]) == 3
    for reg in (ours, theirs):
        assert reg.versions("toy") == [1, 2, 3] and reg.names() == ["toy"]
        assert reg.features("toy", 1) == ["a", "b"]
        assert reg.schema("toy") == {"a": "float32", "b": "int64"}
        assert reg.get("toy", 2)["format"] == "npz" and reg.get("toy", 1)["format"] == "tfrecord"
        assert reg.path("toy") == paths["dir"]
        assert reg.resolve("registry://toy@1")["description"] == "port"
    for v in (1, 2, 3):
        a, b = ours.get("toy", v), theirs.get("toy", v)
        assert a == b
    with pytest.raises(ValueError, match="immutable"):
        ours.register("toy", paths["npz"], version=2)
    with pytest.raises(KeyError, match="No dataset"):
        ours.get("ghost")
    assert registry.parse_uri("registry://toy@7") == jax_registry.parse_uri("registry://toy@7")
    assert registry.is_registry_uri("registry://toy") and not registry.is_registry_uri(3)


def test_registry_uris_resolve_in_the_loader_and_from_path(tmp_path, monkeypatch):
    cols, paths = _formats(tmp_path)
    root = str(tmp_path / "reg")
    registry.DatasetRegistry(root=root).register("toy", paths["dir"])
    registry.DatasetRegistry(root=root).register("toy", paths["npz"])
    got = data.load_path_dataset("registry://toy@1", registry_root=root)
    _same(got, jax_data.load_path_dataset("registry://toy@1", registry_root=root))
    monkeypatch.setenv(registry.REGISTRY_ROOT_ENV_VAR, root)
    _same(data.load_path_dataset("registry://toy"), cols)  # latest: the npz
    it = ShardedBatchIterator.from_path("registry://toy@1", batch_size=4, shard_by="file",
                                        shard_count=2, current_shard=0, shuffle=False)
    jit = jax_data.ShardedBatchIterator.from_path("registry://toy@1", batch_size=4,
                                                   shard_by="file", shard_count=2,
                                                   current_shard=0, shuffle=False)
    ours, theirs = list(it), list(jit)
    assert len(ours) == len(theirs) == ROWS // 2 // 4
    for a, b in zip(ours, theirs):
        _same(a, {k: np.asarray(v) for k, v in b.items()})
    rows = ShardedBatchIterator.from_path("registry://toy", batch_size=ROWS, shuffle=False)
    assert np.array_equal(next(iter(rows))["a"], cols["a"])
    with pytest.raises(ValueError, match="shard_by"):
        ShardedBatchIterator.from_path("registry://toy", batch_size=4, shard_by="col")


def test_feature_dropping_generator_returns_fresh_copies(tmp_path):
    _, paths = _formats(tmp_path)
    for source in (paths["tfrecord"], data.load_path_dataset(paths["npz"])):
        gen = data.feature_dropping_generator(source)
        first = gen(ablated_feature="b")
        assert sorted(first) == ["a"]
        first["a"][:] = 0.0
        assert float(np.abs(gen()["a"]).sum()) > 0  # the next trial's copy is untouched
        with pytest.raises(KeyError, match="cabin"):
            gen(ablated_feature="cabin")
        ref = jax_data.feature_dropping_generator(source)(ablated_feature="a")
        _same(gen(ablated_feature="a"), ref)


def test_concurrent_auto_versioning_never_drops_a_writer(tmp_path):
    """tests/test_registry.py:96's case: four threads auto-version one name
    at once; each gets a distinct version or a loud error, and the registry
    lists exactly the winners."""
    _, paths = _formats(tmp_path)
    schema = {"a": "float32", "b": "int64"}
    barrier = threading.Barrier(4)
    versions, errors, lock = [], [], threading.Lock()

    def register():
        reg = registry.DatasetRegistry()
        barrier.wait()
        try:
            v = reg.register("autokey", paths["npz"], schema=schema)
            with lock:
                versions.append(v)
        except ValueError as e:
            assert "registered" in str(e)
            with lock:
                errors.append(1)

    threads = [threading.Thread(target=register) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(versions) + len(errors) == 4 and len(versions) == len(set(versions))
    assert registry.DatasetRegistry().versions("autokey") == sorted(versions)
    assert os.path.isdir(registry.DatasetRegistry().root)
