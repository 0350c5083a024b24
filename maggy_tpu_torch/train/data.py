"""Input pipeline: per-rank sharding, device placement, path datasets.

Copy of ``maggy_tpu/train/data.py`` (parity: reference `maggy/core/
patching.py` — in-memory datasets sharded by the DistributedSampler
contract, :50-68, with automatic device movement, :89-107, and path
datasets sharded by row or file, :69-81). The JAX package's ``mesh``
becomes a torch ``device``; the seeded permutation is the same, so both
packages yield the same index sequence; given a ``ShardingEnv`` (``env``,
the JAX iterator's ``mesh``) each batch becomes this rank's slice of it on
the rank's device (``ShardingEnv.shard_batch``). ``drop_feature`` and
``feature_dropping_generator`` are LOCO's dataset ablation. Parquet needs
``pyarrow``, imported only when a parquet path is loaded, as in the JAX
package; where it is not installed (the card's machine) a parquet path
raises ``ImportError``, and ``.npz``, TFRecord and ``registry://`` paths
load without it.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch


class ShardedBatchIterator:
    """Iterate minibatches of a dict-of-arrays dataset, restricted to this
    process's shard, optionally placed on a torch ``device`` or, with
    ``env``, sliced and placed for this rank of a mesh."""

    def __init__(
        self,
        data: Dict[str, np.ndarray],
        batch_size: int,
        shard_count: int = 1,
        current_shard: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        device=None,
        epochs: Optional[int] = 1,
        prefetch: int = 0,
        env=None,
    ):
        if not data:
            raise ValueError("Empty dataset.")
        sizes = {k: len(v) for k, v in data.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError("All arrays must share the leading dim: {}".format(sizes))
        if not (0 <= current_shard < shard_count):
            raise ValueError("current_shard must be in [0, shard_count)")
        self.data = data
        self.n = next(iter(sizes.values()))
        self.batch_size = batch_size
        self.shard_count = shard_count
        self.current_shard = current_shard
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.device = None if device is None else torch.device(device)
        self.env = env
        self.epochs = epochs
        self.prefetch = prefetch

    @classmethod
    def from_path(cls, path: str, batch_size: int, columns: Optional[list] = None,
                  shard_by: str = "row", shard_count: int = 1, current_shard: int = 0,
                  **kwargs) -> "ShardedBatchIterator":
        """An iterator over an on-disk dataset (any path ``load_path_dataset``
        reads, ``registry://`` URIs included). ``shard_by="row"`` gives each
        shard disjoint rows of one shared permutation; ``shard_by="file"``
        assigns whole files of a directory round-robin to shards before
        loading, so each reads only its own (JAX ``data.py:99-130``)."""
        if shard_by not in ("row", "file"):
            raise ValueError("shard_by must be 'row' or 'file'")
        if shard_by == "file":
            data = load_path_dataset(path, columns=columns,
                                     file_shard=(current_shard, shard_count))
            # Rows within this shard's files all belong to this shard.
            return cls(data, batch_size, shard_count=1, current_shard=0, **kwargs)
        data = load_path_dataset(path, columns=columns)
        return cls(data, batch_size, shard_count=shard_count, current_shard=current_shard,
                   **kwargs)

    def _shard_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            # Same permutation on every shard (seeded by epoch), disjoint
            # slices per shard — the DistributedSampler contract.
            rng = np.random.default_rng(self.seed + epoch)
            idx = rng.permutation(idx)
        return idx[self.current_shard::self.shard_count]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        it = self._generate()
        # Gather + host-to-device copy run in a producer thread, `prefetch`
        # batches ahead, so input staging overlaps earlier steps.
        return prefetch_iterator(it, self.prefetch) if self.prefetch > 0 else it

    def _generate(self) -> Iterator[Dict[str, Any]]:
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            idx = self._shard_indices(epoch)
            stop = len(idx) - self.batch_size + 1 if self.drop_remainder else len(idx)
            for start in range(0, max(stop, 0), self.batch_size):
                sel = idx[start:start + self.batch_size]
                batch = {k: v[sel] for k, v in self.data.items()}
                if self.env is not None:
                    batch = self.env.shard_batch(batch)
                elif self.device is not None:
                    batch = self._place(batch)
                yield batch
            epoch += 1

    def _place(self, batch):
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def __len__(self) -> int:
        # Exact size of THIS shard's slice idx[current_shard::shard_count]
        # (early shards get the ceil share).
        per_shard = (self.n - self.current_shard + self.shard_count - 1) // self.shard_count
        full = per_shard // self.batch_size
        if not self.drop_remainder and per_shard % self.batch_size:
            full += 1
        return full * (self.epochs or 1)


def prefetch_iterator(iterator, size: int = 2):
    """Run ``iterator`` in a daemon producer thread, keeping up to ``size``
    items staged. Producer exceptions re-raise at the consumer."""
    if size < 1:
        raise ValueError("prefetch size must be >= 1")
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    errors: list = []
    stop = threading.Event()

    def put(item) -> None:
        # Bounded put that watches for consumer abandonment: an early-
        # stopped trial drops the generator mid-epoch, and the producer must
        # not stay blocked on a full queue forever.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def producer():
        try:
            for item in iterator:
                put(item)
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised at the consumer
            errors.append(e)
        finally:
            put(end)

    threading.Thread(target=producer, daemon=True, name="batch-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is end:
                if errors:
                    raise errors[0]
                return
            yield item
    finally:
        stop.set()


def drop_feature(data: Dict[str, Any], feature: Optional[str]) -> Dict[str, Any]:
    """Dict-of-arrays minus one column: the LOCO dataset ablation step. The
    values alias the input arrays; ``feature_dropping_generator`` adds the
    per-trial copies. An unknown feature raises: silently dropping nothing
    would corrupt the study's comparison."""
    if feature is None:
        return dict(data)
    if feature not in data:
        raise KeyError("Ablated feature {!r} is not a column of the dataset "
                       "(have: {}).".format(feature, sorted(data)))
    return {k: v for k, v in data.items() if k != feature}


def feature_dropping_generator(source):
    """A LOCO ``dataset_generator``: ``gen(ablated_feature=None)`` returns
    the training data as a dict of arrays minus the ablated feature.
    ``source`` is a dict of arrays or a path ``load_path_dataset`` reads,
    loaded once and cached. Each call returns fresh copies: trials normalize
    in place, and runner threads share this generator."""
    cache = {}

    def generator(ablated_feature: Optional[str] = None):
        if isinstance(source, str):
            if "data" not in cache:
                cache["data"] = load_path_dataset(source)
            data = cache["data"]
        else:
            data = source
        return {k: np.array(v, copy=True) for k, v in drop_feature(data, ablated_feature).items()}

    return generator


def _file_shard(files, file_shard, kind):
    if file_shard is None:
        return files
    current, count = file_shard
    if count > len(files):
        raise ValueError("{} shards but only {} {} files; use shard_by='row'".format(
            count, len(files), kind))
    return files[current::count]


def load_path_dataset(path, columns=None, file_shard=None, registry_root=None):
    """Load an on-disk dataset into a dict of numpy arrays: a ``.npz``
    archive, a ``.tfrecord``/``.tfrecords`` file or a directory of them, a
    ``.parquet`` file or a directory of them, or a ``registry://name[@v]``
    URI resolved through the dataset registry (``registry_root`` or
    $MAGGY_TPU_REGISTRY_ROOT for a registry outside the default root).
    ``file_shard=(current, count)`` keeps files ``[current::count]`` of a
    directory; a single file rejects it (JAX ``data.py:238-318``)."""
    from maggy_tpu_torch.train import registry, tfrecord

    if registry.is_registry_uri(path):
        path = registry.resolve_path(path, root=registry_root)
    single = file_shard is not None and file_shard[1] > 1
    if tfrecord.is_tfrecord_path(path):
        if os.path.isdir(path):
            files = _file_shard(sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if f.endswith((".tfrecord", ".tfrecords"))), file_shard, "tfrecord")
        elif single:
            raise ValueError("file-level sharding needs a tfrecord directory")
        else:
            files = [path]
        return tfrecord.load_tfrecord_dataset(files, columns=columns)
    if path.endswith(".npz"):
        if single:
            raise ValueError("file-level sharding needs a parquet directory")
        with np.load(path) as archive:
            return {k: archive[k] for k in (columns or list(archive.keys()))}
    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith(".parquet"))
        if not files:
            raise ValueError("No .parquet files under {}".format(path))
        files = _file_shard(files, file_shard, "parquet")
    elif path.endswith(".parquet"):
        if single:
            raise ValueError("file-level sharding needs a parquet directory")
        files = [path]
    else:
        raise ValueError("Unsupported dataset path {!r} (.npz, .tfrecord, .parquet, or a "
                         "directory of .tfrecord or .parquet files)".format(path))
    import pyarrow as pa
    import pyarrow.parquet as pq

    tables = [pq.read_table(f, columns=columns) for f in files]
    table = tables[0] if len(tables) == 1 else pa.concat_tables(tables)
    return {name: np.asarray(table.column(name).to_numpy(zero_copy_only=False))
            for name in table.column_names}
