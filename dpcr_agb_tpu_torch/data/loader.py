"""Host-side batch loader (counterpart of `dpcr_agb_tpu/data/loader.py`):
per-sample train or eval chain, fixed-shape collate and post_collate, with
batches built concurrently on `num_workers` threads and handed out in
order, so host work overlaps the card's steps.

Determinism: each sample's transform generator comes from
SeedSequence(entropy=seed, spawn_key=(epoch, position + 1)) and the
sampler's from (epoch, 0), a pure function of the run's seed, the epoch
and the position in the epoch's index stream, whatever the threads do: the
same batches as the JAX package's loader. With `shard=(rank, world)`
(several processes) each process builds its contiguous slice of every
global batch; the slices put together are the one-process batches.

`put_fn` runs on the loader thread after post_collate, e.g.
`data.batch.device_put` with a copy stream of the loader's own: the copy of
batch k+1 to the card then overlaps the step of batch k, and the step waits
on the batch's event (`data.batch.wait_ready`) before it reads it."""
from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from .batch import Batch, CollateSpec, collate
from .dataset import Las, RandomSampler


class Loader:
    def __init__(self, dataset: Las, transform: Callable, batch_size: int,
                 spec: CollateSpec, shuffle: bool = False,
                 double_batch: bool = False, drop_last: bool = True,
                 seed: int = 0, num_workers: int = 4, prefetch: int = 2,
                 post_collate: Optional[Callable] = None,
                 pre_batch_collate: Optional[Callable] = None,
                 shard: Optional[Tuple[int, int]] = None,
                 put_fn: Optional[Callable] = None):
        # several processes: shard=(rank, world). batch_size stays global;
        # every process walks the same index stream (one seed) and builds
        # only its contiguous batch_size/world slice of each batch, each
        # sample's generator keyed on its global position, so the ranks'
        # batches put together are the one-process batch bit for bit
        self.shard = tuple(shard) if shard is not None else (0, 1)
        pi, pc = self.shard
        if batch_size % pc:
            raise ValueError(f"batch_size {batch_size} must divide by "
                             f"process_count {pc}")
        if double_batch and (batch_size // pc) % 2:
            raise ValueError("double_batch pairs are adjacent; the local "
                             "per-process batch must be even")
        self.local_batch_size = batch_size // pc
        self.dataset = dataset
        self.transform = transform
        self.batch_size = batch_size
        self.spec = spec
        self.shuffle = shuffle
        self.double_batch = double_batch
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.post_collate = post_collate
        self.pre_batch_collate = pre_batch_collate
        self.put_fn = put_fn
        self.sampler = RandomSampler(len(dataset), batch_size, double_batch) \
            if shuffle else None

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        if self.sampler is not None:
            rng = np.random.default_rng(
                np.random.SeedSequence(entropy=self.seed,
                                       spawn_key=(epoch, 0)))
            return self.sampler.indices(rng)
        idx = np.arange(len(self.dataset))
        if self.drop_last and len(idx) >= self.batch_size:
            idx = idx[:(len(idx) // self.batch_size) * self.batch_size]
        return idx

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.double_batch and self.shuffle:
            n *= 2
        if self.drop_last or self.shuffle:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_sample(self, epoch: int, position: int, idx: int,
                     is_double: bool) -> dict:
        sample = self.dataset.get(int(idx))
        sample["is_double"] = is_double
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed,
                                   spawn_key=(epoch, position + 1)))
        return self.transform(rng, sample)

    def _build(self, epoch: int, bi: int, batch_idx: np.ndarray) -> Batch:
        """This process's part of one batch: chains, collate, post_collate,
        put_fn."""
        # the double-batch pairing looks at the global index stream, then
        # the process keeps its own contiguous slice
        doubles = np.zeros(len(batch_idx), dtype=bool)
        doubles[1:] = batch_idx[1:] == batch_idx[:-1]
        local = self.local_batch_size
        lo = min(self.shard[0] * local, len(batch_idx))
        hi = min(lo + local, len(batch_idx))
        samples = [self._make_sample(epoch, bi * self.batch_size + j,
                                     batch_idx[j], doubles[j])
                   for j in range(lo, hi)]
        empty = not samples
        if empty:
            # a ragged final batch left this process nothing: an all-padding
            # batch keeps it in the collectives
            samples = [self._make_sample(epoch, bi * self.batch_size,
                                         batch_idx[0], False)]
        if self.pre_batch_collate is not None:
            # may drop samples; the dropped tail becomes batch padding
            samples = self.pre_batch_collate(samples)
        b = collate(samples, self.spec, pad_to_batch=local,
                    n_valid=0 if empty else None)
        if self.post_collate is not None:
            b = self.post_collate(b)
        if self.put_fn is not None:
            b = self.put_fn(b)
        return b

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        indices = self._epoch_indices(epoch)
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if not batches:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    futs: deque = deque()
                    it = iter(enumerate(batches))
                    exhausted = False
                    in_flight = self.num_workers + self.prefetch
                    while not stop.is_set():
                        while not exhausted and len(futs) < in_flight:
                            try:
                                bi, bidx = next(it)
                            except StopIteration:
                                exhausted = True
                                break
                            futs.append(pool.submit(self._build, epoch, bi,
                                                    bidx))
                        if not futs:
                            break
                        q.put(futs.popleft().result())
            except BaseException as e:  # surface worker errors to the caller
                q.put(e)
            finally:
                q.put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5)
