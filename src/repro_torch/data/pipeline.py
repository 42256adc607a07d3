"""Deterministic, sharded, resumable synthetic-LM data pipeline.

A copy of the JAX package's ``data/pipeline.py`` (numpy only), kept in
the port so that it imports nothing of that package: batch ``i`` of a
config is the reference's, bit for bit.

Production properties the trainer relies on:
  * determinism & resumability — batch ``i`` is a pure function of
    (seed, i); restart at step N replays exactly the stream from N
    (checkpoint stores only the step counter, not pipeline state);
  * host sharding — each host materializes only its ``host_index`` slice
    of the global batch (scales to any host count);
  * background prefetch — a small thread-ahead queue hides generation
    latency behind the device step;
  * packing — documents of random length are packed into fixed (B, S)
    token blocks with EOS separators, the standard LM pretraining layout.

Synthetic text: a mixture of Zipf-distributed unigrams and a Markov chain
over a small state space — enough structure that a ~100M model's loss
visibly drops, while needing no external data.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_count: int = 1
    host_index: int = 0
    mean_doc_len: int = 256
    eos_id: int = 0
    zipf_a: float = 1.3
    markov_states: int = 64
    prefetch: int = 2


class SyntheticLM:
    """Zipf+Markov token source with per-(seed, step) determinism."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.host_count == 0
        self.local_batch = cfg.global_batch // cfg.host_count
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed transition structure shared by all batches
        self._trans = base.integers(1, v, size=(cfg.markov_states, 8))
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._zipf = probs / probs.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_index))
        B, S = self.local_batch, cfg.seq_len
        tokens = np.empty((B, S + 1), np.int32)
        for b in range(B):
            tokens[b] = self._pack_row(rng, S + 1)
        return {"tokens": tokens[:, :-1],
                "labels": tokens[:, 1:].copy()}

    def _pack_row(self, rng, length: int) -> np.ndarray:
        cfg = self.cfg
        out = np.empty(length, np.int32)
        pos = 0
        while pos < length:
            doc_len = min(int(rng.exponential(cfg.mean_doc_len)) + 8,
                          length - pos)
            state = int(rng.integers(cfg.markov_states))
            # zipf unigrams with markov "topic" offsets
            uni = rng.choice(cfg.vocab_size, size=doc_len, p=self._zipf)
            mark = self._trans[state, rng.integers(0, 8, size=doc_len)]
            mix = rng.random(doc_len) < 0.5
            doc = np.where(mix, uni, mark).astype(np.int32)
            doc[-1] = cfg.eos_id
            out[pos:pos + doc_len] = doc
            pos += doc_len
        return out


class _Prefetcher:
    def __init__(self, src: SyntheticLM, start_step: int, depth: int):
        self.src = src
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.src.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()


def make_pipeline(cfg: DataConfig, start_step: int = 0,
                  prefetch: bool = True):
    """Iterator of (step, {tokens, labels}) from ``start_step``."""
    src = SyntheticLM(cfg)
    if prefetch:
        return _Prefetcher(src, start_step, cfg.prefetch)

    def gen():
        step = start_step
        while True:
            yield step, src.batch(step)
            step += 1
    return gen()
