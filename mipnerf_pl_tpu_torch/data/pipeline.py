"""Host -> device input pipeline: prefetched ray batches.

Counterpart of mipnerf_pl_tpu/data/pipeline.py.  A background thread
gathers numpy ray batches and, for a CUDA device, copies them from pinned
host memory with `.to(device, non_blocking=True)` on a side stream while
the previous step computes; the consumer's stream waits on the copy's
event, so the training loop never blocks the host on a transfer.  On the
CPU the batches are the gathered arrays as tensors.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from mipnerf_pl_tpu_torch.native import gather
from mipnerf_pl_tpu_torch.rays import Rays
from mipnerf_pl_tpu_torch.utils.trace import span


class TrainBatcher:
    """Infinite iterator of (Rays, pixels) batches of tensors on `device`.

    Args:
      dataset: a train-split dataset exposing `sample_batch(rng, n)` and,
        for a shard, `sample_indices(rng, n)` and `gather(idx)`.
      batch_size: rays per training step, over every data shard.
      seed: numpy seed for the host-side ray sampler.
      prefetch: number of batches to keep in flight (>=1 enables the
        background thread; 0 is fully synchronous, used by tests).
      steps_per_call: K > 1 yields [K, B, C] stacks for the multi-step
        trainer (one draw of K * B rays, as the JAX batcher makes it).
      device: where the batches go (default: the CPU).
      shard: (r, d): gather only row block r of d of each step's batch,
        the rows of data shard r.  Every shard draws the same indices from
        the same seed, so d shards together see the one-device batch
        sequence, whatever d is (None: the whole batch).
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 prefetch: int = 2, steps_per_call: int = 1, device='cpu',
                 shard: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.steps_per_call = steps_per_call
        rank, d = shard or (0, 1)
        if batch_size % d:
            raise ValueError(f'train.batch_size={batch_size} does not divide '
                             f'among data={d} shards')
        per = batch_size // d
        self.rows = (rank * per, (rank + 1) * per)
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == 'cuda' else None)
        self._queue: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        # The datasets gather through the native library: build it here,
        # in set-up, so that no timed training loop pays for the build.
        gather.library()
        if prefetch > 0:
            self._queue = queue.Queue(maxsize=prefetch)
            self._thread = threading.Thread(target=self._producer,
                                            daemon=True)
            self._thread.start()

    def _make_batch(self):
        """-> (rays, pixels, the copy's event or None)."""
        k = self.steps_per_call
        start, stop = self.rows
        if stop - start == self.batch_size:
            rays, pixels = self.dataset.sample_batch(self.rng,
                                                     k * self.batch_size)
        else:
            # The whole draw, then this shard's rows of each step.
            idx = self.dataset.sample_indices(self.rng, k * self.batch_size)
            rays, pixels = self.dataset.gather(
                idx.reshape(k, self.batch_size)[:, start:stop].reshape(-1))
        if k > 1:
            # [K*B, C] -> [K, B, C] stacks for the multi-step trainer.
            def reshape(x):
                return x.reshape(k, stop - start, x.shape[-1])
            rays = Rays(*[reshape(f) for f in rays])
            pixels = reshape(pixels)
        return self._put_on_device(rays, pixels)

    def _put_on_device(self, rays: Rays, pixels: np.ndarray):
        # float32 on the device, whatever the dataset computed in (numpy
        # promotes the Blender directions to float64).
        host = [torch.from_numpy(np.ascontiguousarray(f, dtype=np.float32))
                for f in (*rays, pixels)]
        if self._copy_stream is None:
            return Rays(*host[:-1]), host[-1], None
        with torch.cuda.stream(self._copy_stream):
            dev = [t.pin_memory().to(self.device, non_blocking=True)
                   for t in host]
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        return Rays(*dev[:-1]), dev[-1], copied

    def _producer(self):
        try:
            while not self._stop.is_set():
                batch = self._make_batch()
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # handed to the consumer by __next__
            self._error = e
            self._stop.set()

    def __iter__(self) -> Iterator:
        return self

    def _take(self):
        if self._queue is None:
            return self._make_batch()
        while True:
            if self._error is not None:
                raise RuntimeError(
                    'TrainBatcher producer thread failed') from self._error
            try:
                return self._queue.get(timeout=5.0)
            except queue.Empty:
                if self._error is None and self._stop.is_set():
                    raise RuntimeError('TrainBatcher closed') from None

    def __next__(self):
        with span('mip.batch'):
            rays, pixels, copied = self._take()
            if copied is not None:
                # The consumer's stream waits for the copy, and the tensors,
                # allocated on the copy stream, are marked as used on it.
                current = torch.cuda.current_stream(self.device)
                current.wait_event(copied)
                for t in (*rays, pixels):
                    t.record_stream(current)
            return rays, pixels

    def close(self):
        """Stop the producer and drop what it queued.  The wait is bounded,
        so a producer wedged in a copy cannot hang the caller (it is a
        daemon thread)."""
        self._stop.set()
        if self._queue is None:
            return

        def drain():
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
        # Drain until the producer has seen the stop flag and exited, then
        # once more: its last put can land between a drain and the check.
        deadline = time.monotonic() + 10.0
        while True:
            drain()
            if not self._thread.is_alive() or time.monotonic() > deadline:
                break
            self._thread.join(timeout=0.1)
        drain()
