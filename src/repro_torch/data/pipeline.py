"""Deterministic sharded token pipeline (numpy only).

The port's copy of ``repro.data.pipeline``: the same sources, seeds and
batches bit for bit, so the port trains on the reference's data.

Production shape: each host reads only its shard of the stream, batches
are packed to fixed (B, S), and every batch is addressable by step index
(deterministic restart: resuming at step k reproduces batch k bit-exactly
without replaying the stream — the fault-tolerance contract).

Sources:
  * SyntheticLM     — seeded Markov-ish byte stream with learnable
                      structure (n-gram skeleton), used by examples/tests
                      (the container has no enwik8; §Accuracy uses this).
  * FileByteSource  — byte-level LM over a local file (enwik8-compatible
                      char-level setup from the paper, if a corpus is
                      mounted).
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 256
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1


class SyntheticLM:
    """Seeded synthetic byte LM with predictable n-gram structure.

    Tokens follow a sparse order-2 Markov chain derived from the seed, so
    a model can reach well-below-uniform perplexity quickly — giving the
    ANN/SNN/HNN accuracy comparison (paper Table 4) signal on CPU.
    """

    K = 8          # candidates per context
    NOISE = 0.05   # uniform-replacement rate

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab
        # order-1 chain: V contexts x K candidates, geometric weights —
        # dense enough that a small model sees every context often and
        # can reach the ~1.4-nat conditional entropy floor quickly
        self.table = rng.integers(0, V, size=(V, self.K)).astype(np.int32)
        w = 0.5 ** np.arange(self.K)
        self.probs = w / w.sum()

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        assert cfg.global_batch % cfg.n_hosts == 0
        b_host = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(
            (cfg.seed, step, self.cfg.host_id, 0xBEEF))
        V = cfg.vocab
        toks = np.zeros((b_host, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, b_host)
        noise = rng.random((b_host, cfg.seq_len + 1)) < self.NOISE
        choice = rng.choice(self.K, size=(b_host, cfg.seq_len + 1),
                            p=self.probs)
        rand_tok = rng.integers(0, V, (b_host, cfg.seq_len + 1))
        for t in range(1, cfg.seq_len + 1):
            nxt = self.table[toks[:, t - 1], choice[:, t]]
            toks[:, t] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class FileByteSource:
    """Byte-level LM batches from a file (enwik8-style char-level)."""

    def __init__(self, cfg: DataConfig, path: str):
        self.cfg = cfg
        self.data = np.fromfile(path, dtype=np.uint8)
        assert len(self.data) > cfg.seq_len + 1, path

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        b_host = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng((cfg.seed, step, cfg.host_id))
        starts = rng.integers(0, len(self.data) - cfg.seq_len - 1, b_host)
        toks = np.stack([self.data[s:s + cfg.seq_len + 1] for s in starts])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Background-thread prefetch (overlap host data prep with device
    compute); preserves deterministic step indexing."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self.q.put((s, self.source.batch(s)), timeout=0.5)
                s += 1
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self.t.join(timeout=2)
