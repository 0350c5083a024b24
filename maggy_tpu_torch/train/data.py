"""Input pipeline: per-rank sharding and device placement.

Copy of ``ShardedBatchIterator`` and ``prefetch_iterator`` of
``maggy_tpu/train/data.py:20-195`` (parity: reference `maggy/core/
patching.py` — in-memory datasets sharded by the DistributedSampler
contract, :50-68, with automatic device movement, :89-107). The JAX
package's ``mesh`` becomes a torch ``device``; the seeded permutation is the
same, so both packages yield the same index sequence. Path datasets
(``from_path``, ``load_path_dataset``) are not ported yet.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch


class ShardedBatchIterator:
    """Iterate minibatches of a dict-of-arrays dataset, restricted to this
    process's shard, optionally placed on a torch ``device``."""

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
        self.epochs = epochs
        self.prefetch = prefetch

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
                if self.device is not None:
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
