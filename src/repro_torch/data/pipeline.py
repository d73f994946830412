"""Deterministic synthetic tokenized data pipeline.

A copy of the JAX package's ``data/pipeline.py``, which has no JAX in it:
``batch_at`` returns NumPy arrays, and the train step moves them to its
device.

Design goals of a production loader, scaled to this container:
  * stateless addressing — ``batch_at(step)`` is a pure function of
    (seed, step, topology), so resume-after-failure is exact without
    loader checkpoints and every DP rank can compute its own shard;
  * learnable structure — an order-2 noisy Markov stream so integration
    tests can assert loss decreases;
  * background prefetch with a bounded queue.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


def _mix(*xs: int) -> np.random.Generator:
    seed = 0x9E3779B97F4A7C15
    for x in xs:
        seed = (seed ^ (x + 0x9E3779B9)) * 0xBF58476D1CE4E5B9 % (1 << 63)
    return np.random.default_rng(seed)


@dataclass(frozen=True)
class SyntheticCorpus:
    vocab_size: int
    seed: int = 0
    noise: float = 0.05

    def sequence(self, idx: int, length: int) -> np.ndarray:
        """Deterministic order-2 Markov sequence #idx."""
        rng = _mix(self.seed, idx)
        v = self.vocab_size
        a = int(rng.integers(1, v))
        c = int(rng.integers(0, v))
        toks = np.empty(length + 1, np.int64)
        toks[0] = rng.integers(0, v)
        toks[1] = rng.integers(0, v)
        for t in range(2, length + 1):
            nxt = (a * toks[t - 1] + 3 * toks[t - 2] + c) % v
            if rng.random() < self.noise:
                nxt = rng.integers(0, v)
            toks[t] = nxt
        return toks.astype(np.int32)


@dataclass(frozen=True)
class LoaderConfig:
    global_batch: int
    seq_len: int
    dp_rank: int = 0
    dp_size: int = 1

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.dp_size == 0
        return self.global_batch // self.dp_size


class DataLoader:
    """Sharded, deterministic, prefetching loader over SyntheticCorpus."""

    def __init__(self, corpus: SyntheticCorpus, cfg: LoaderConfig,
                 prefetch: int = 2):
        self.corpus = corpus
        self.cfg = cfg
        self.prefetch = prefetch

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        base = step * c.global_batch + c.dp_rank * c.local_batch
        seqs = np.stack([self.corpus.sequence(base + i, c.seq_len)
                         for i in range(c.local_batch)])
        return {"tokens": seqs[:, :-1].astype(np.int32),
                "labels": seqs[:, 1:].astype(np.int32)}

    def iterate(self, start_step: int = 0,
                stop_step: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            s = start_step
            while not stop.is_set() and (stop_step is None or s < stop_step):
                q.put((s, self.batch_at(s)))
                s += 1
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item[1]
        finally:
            stop.set()
