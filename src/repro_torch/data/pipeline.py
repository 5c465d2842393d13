"""Deterministic, checkpointable, shardable synthetic LM data pipeline.

The port's own copy of ``repro.data.pipeline`` (numpy only, line for line),
so that both packages train on the same batches.

Every batch is a pure function of ``(seed, step)`` — so the entire pipeline
state is a single step counter (checkpointed by TCE next to the train state),
restart is exactly-once, and any DP rank can materialise just its slice
(``batch_slice``) with no coordination. Tokens follow a Zipf marginal with a
first-order Markov structure so models show a real, decreasing loss.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class DataState:
    step: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    @staticmethod
    def from_dict(d) -> "DataState":
        return DataState(int(d["step"]))


class SyntheticLMData:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, zipf_a: float = 1.3, n_patterns: int = 64):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.state = DataState()
        # fixed Markov pattern table: next = (cur * mult + add) % vocab
        rng = np.random.default_rng(seed ^ 0x5EED)
        self._mult = rng.integers(1, vocab_size, n_patterns)
        self._add = rng.integers(0, vocab_size, n_patterns)
        self._zipf_a = zipf_a

    # ------------------------------------------------------------------ #
    def _gen(self, step: int, rows: np.ndarray) -> Dict[str, np.ndarray]:
        # per-(step, row) counter-based RNG: any slice of the global batch is
        # bit-identical to the same rows of the full batch (shardability)
        n = len(rows)
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 0, step, 0]))
        # jump each row to its own independent stream
        streams = [np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, int(r), step, 1])) for r in rows]
        pat = np.array([s.integers(0, len(self._mult)) for s in streams])
        start = np.array([s.zipf(self._zipf_a) % self.vocab for s in streams])
        noise = np.stack([s.random(self.seq) for s in streams])
        rand_tok = np.stack([s.integers(0, self.vocab, self.seq)
                             for s in streams])
        toks = np.empty((n, self.seq + 1), np.int32)
        toks[:, 0] = start
        cur = start.astype(np.int64)
        mult = self._mult[pat]
        add = self._add[pat]
        for t in range(self.seq):
            cur = (cur * mult + add) % self.vocab
            nxt = np.where(noise[:, t] < 0.15, rand_tok[:, t], cur)
            toks[:, t + 1] = nxt
            cur = nxt.astype(np.int64)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    # ------------------------------------------------------------------ #
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        return self._gen(step, np.arange(self.batch))

    def batch_slice(self, step: int, rank: int, n_ranks: int
                    ) -> Dict[str, np.ndarray]:
        per = self.batch // n_ranks
        return self._gen(step, np.arange(rank * per, (rank + 1) * per))

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b

    def restore(self, state: DataState) -> None:
        self.state = DataState(state.step)
