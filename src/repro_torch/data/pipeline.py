"""Deterministic synthetic token pipeline.

Port of ``repro.data.pipeline``: the batch at step ``s`` is a pure
function of ``(seed, s, rows)``, generated with numpy exactly as the JAX
package does (so the two packages see bitwise the same tokens), then
handed over as int64 tensors on the requested device. On a mesh
(``sharding=``) each rank takes its rows of every step's global batch
(``sharding.partition.batch_rows``): the batch is the same global
``batch_at(step)``, cut after it is made. A background thread prefetches
``prefetch`` steps ahead.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.sharding import partition


class SyntheticTokens:
    """LM token batches: (tokens, targets, positions) of (B, S).

    A mixed-congruential walk over the vocab rather than iid uniform, so
    losses move during smoke training.
    """

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed

    def batch_at(self, step: int, lo: int = 0, hi: Optional[int] = None
                 ) -> dict:
        """Rows [lo, hi) of the batch at ``step`` as int32 numpy arrays."""
        hi = self.batch if hi is None else hi
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, lo, hi]))
        n = hi - lo
        start = rng.integers(0, self.vocab, (n, 1), np.int64)
        stride = rng.integers(1, 7, (n, 1), np.int64)
        idx = np.arange(self.seq + 1, dtype=np.int64)[None, :]
        walk = (start + stride * idx + (idx * idx) // 7) % self.vocab
        toks = walk.astype(np.int32)
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "positions": np.broadcast_to(
                np.arange(self.seq, dtype=np.int32), (n, self.seq)).copy(),
        }

    def tensors_at(self, step: int, device=None) -> dict:
        """The batch at ``step`` as int64 tensors on ``device``."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    device=device, dtype=torch.int64)
                for k, v in self.batch_at(step).items()}


def make_batch_iterator(ds: SyntheticTokens, *, start_step: int = 0,
                        device=None, prefetch: int = 2,
                        sharding=None) -> Iterator[dict]:
    """Prefetching iterator over steps from ``start_step``; the batches
    are made on the host by a daemon thread and moved to ``device`` by
    the consumer. ``sharding``: a ``(data, model)`` DeviceMesh; each batch
    is then this rank's rows of the global one. Closing the iterator
    stops the thread."""
    q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()
    rows = slice(None)
    if sharding is not None:
        rows = slice(*partition.batch_rows(sharding, ds.batch)[:2])

    def producer():
        step = start_step
        while not stop.is_set():
            item = {k: v[rows] for k, v in ds.batch_at(step).items()}
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    def gen():
        try:
            while True:
                b = q.get()
                yield {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                           device=device, dtype=torch.int64)
                       for k, v in b.items()}
        finally:
            stop.set()
            t.join(timeout=5)

    return gen()
