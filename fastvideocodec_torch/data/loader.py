"""Host-to-device input pipeline, ported from
fastvideocodec_tpu/data/loader.py: one background thread stacks batches
and copies them to the device while the previous step computes.

The thread puts at most ``depth`` batches in a bounded queue. A batch
bound for a CUDA device is pinned and copied with ``non_blocking``. No
DataLoader workers and no processes are started."""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

JOIN_TIMEOUT_S = 60.0


def prefetch_batches(dataset, batch_indices, batch_size: int = 1, depth: int = 2,
                     device="cuda"):
    """Yields float32 tensors on ``device`` stacked from dataset[idx] over
    ``batch_indices``, ``batch_size`` at a time (the last batch may be
    smaller), in the dataset's layout ([B, 7, S, S, 3] for FrameDataset).
    An exception in the thread is raised here."""
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def to_device(batch):
        t = torch.from_numpy(np.stack(batch).astype(np.float32, copy=False))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def worker():
        try:
            batch = []
            for idx in batch_indices:
                batch.append(np.asarray(dataset[idx]))
                if len(batch) == batch_size:
                    if not put(to_device(batch)):
                        return
                    batch = []
            if batch and not put(to_device(batch)):
                return
            put(done)
        except Exception as e:  # handed to the consumer, which raises it
            put(e)

    thread = threading.Thread(target=worker, name="prefetch_batches", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=JOIN_TIMEOUT_S)
