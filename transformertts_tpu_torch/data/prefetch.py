"""Background-thread batch prefetcher (``transformertts_tpu/data/prefetch.py``)
and the step from a loader batch to the device.

``prefetch`` overlaps host-side batch assembly (npz decode + pad) with
device execution.  A bounded queue keeps at most ``depth`` batches in flight
so memory stays flat.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import torch

_SENTINEL = object()


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    q: queue.Queue = queue.Queue(maxsize=depth)
    error: list[BaseException] = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer side
            error.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if error:
                raise error[0]
            return
        yield item


def batch_to_device(batch: dict, device) -> dict:
    """A loader batch (numpy arrays with the leading grad-accumulation axis)
    as tensors on ``device``, in the dtypes the training step takes: floats
    fp32, integers int64.  On a CUDA device the copy goes through pinned
    memory and does not block the host."""
    device = torch.device(device)
    out = {}
    for name, x in batch.items():
        t = torch.as_tensor(x)
        t = t.float() if t.is_floating_point() else t.long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[name] = t
    return out
