"""Runner pools: the fan-out substrate replacing Spark executors.

``ThreadRunnerPool`` of ``maggy_tpu/core/runner_pool.py``: N in-process
runner threads sharing the process's CUDA device(s). Process, TPU-pinned,
elastic and remote pools are not ported yet.
"""

from __future__ import annotations

import threading
import traceback
from typing import Callable, List

import torch


def resolve_num_workers(config) -> int:
    """``num_workers="auto"``: one runner per visible CUDA device."""
    nw = getattr(config, "num_workers", 1)
    if nw != "auto":
        return int(nw)
    count = torch.cuda.device_count()
    if count == 0:
        raise ValueError("num_workers='auto' found no CUDA device; pass an "
                         "explicit count")
    return count


class ThreadRunnerPool:
    def __init__(self, num_workers: int):
        self.num_workers = num_workers

    def run(self, worker_fn: Callable[[int], None]) -> List[BaseException]:
        """Run ``worker_fn(partition_id)`` on every runner thread and block
        until all return. Returns the runner failures instead of raising;
        the driver decides whether they are fatal."""
        errors: List[BaseException] = []
        lock = threading.Lock()

        def target(pid: int):
            try:
                worker_fn(pid)
            except BaseException as e:  # noqa: BLE001 - reported to the driver
                with lock:
                    errors.append(e)
                traceback.print_exc()

        threads = [threading.Thread(target=target, args=(i,), name="runner-{}".format(i))
                   for i in range(self.num_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return errors
