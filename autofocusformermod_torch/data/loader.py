"""Training and evaluation loaders: the mapper runs in a thread pool,
training batches are stacked on the host and moved to the device in the
layout the training step reads.

Counterpart of ``autofocusformermod_tpu/data/loader.py`` (``TrainLoader``,
``eval_loader``) plus ``device_batch``.  With several workers the mapper's
one generator is drawn from by several threads at once, so which sample
gets which draw is not fixed (in the JAX package too); one worker keeps the
order.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List

import numpy as np
import torch


def _stack(samples: List[Dict]) -> Dict:
    """Arrays stacked along a new batch axis, other values as lists."""
    return {k: (np.stack([s[k] for s in samples]) if isinstance(v, np.ndarray)
                else [s[k] for s in samples]) for k, v in samples[0].items()}


class TrainLoader:
    """Endless shuffled batches of ``batch_size // process_count`` mapped
    samples: each epoch a permutation from ``seed + process_index``, of which
    this process takes every ``process_count``-th index.  A producer thread
    keeps up to ``prefetch`` batches ready."""

    def __init__(self, dataset: List[Dict], mapper: Callable[[Dict], Dict], batch_size: int, *,
                 seed: int = 0, num_workers: int = 8, prefetch: int = 4, process_index: int = 0,
                 process_count: int = 1):
        assert batch_size % process_count == 0
        self.dataset = dataset
        self.mapper = mapper
        self.local_batch = batch_size // process_count
        self.rng = np.random.default_rng(seed + process_index)
        self.process_index = process_index
        self.process_count = process_count
        self.pool = ThreadPoolExecutor(num_workers)
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _indices(self) -> Iterator[int]:
        n = len(self.dataset)
        while True:
            yield from self.rng.permutation(n)[self.process_index:: self.process_count]

    def _producer(self) -> None:
        idx_iter = self._indices()
        while not self._stop.is_set():
            idxs = [next(idx_iter) for _ in range(self.local_batch)]
            futures = [self.pool.submit(self.mapper, self.dataset[i]) for i in idxs]
            try:
                batch = _stack([f.result() for f in futures])
            except Exception as e:          # handed to the consumer, which raises it
                batch = e
            while True:
                try:
                    self.q.put(batch, timeout=0.05)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        return
            if isinstance(batch, Exception):
                return

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        batch = self.q.get()
        if isinstance(batch, Exception):
            raise batch
        return batch

    def close(self) -> None:
        """Stop the producer (after the batch it is mapping) and the pool."""
        self._stop.set()
        self._thread.join()
        self.pool.shutdown()


def eval_loader(dataset: List[Dict], mapper: Callable[[Dict], Dict], *, process_index: int = 0,
                process_count: int = 1, num_workers: int = 8) -> Iterator[Dict]:
    """This process's shard of ``dataset``, mapped, in order; at most
    2 * num_workers samples are mapped ahead of the one handed out."""
    it = iter(dataset[process_index::process_count])
    with ThreadPoolExecutor(num_workers) as pool:
        pending: deque = deque(pool.submit(mapper, d) for _, d in zip(range(2 * num_workers), it))
        while pending:
            out = pending.popleft().result()
            for d in it:
                pending.append(pool.submit(mapper, d))
                break
            yield out


def device_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A stacked training batch on ``device`` in the training step's layout
    (as ``data/synthetic.py`` yields it): 'image' (b, H, W, 3) uint8,
    'labels' (b, t) int64, 'valid' (b, t) bool, and the targets' pixels:
    a semantic batch's 'sem_seg_map' (b, H, W) uint8 (int32 where the
    ignore label passes 255), a panoptic or instance batch's 'masks' (b, t,
    H, W) uint8."""
    dtypes = {"image": torch.uint8, "sem_seg_map": None, "masks": torch.uint8,
              "labels": torch.long, "valid": torch.bool}
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device=device, dtype=dt)
            for k, dt in dtypes.items() if k in batch}
