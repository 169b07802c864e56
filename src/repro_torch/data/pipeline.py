"""Deterministic, elastically-resharding synthetic LM data pipeline
(supports the paper's iteration-boundary consistent cut, invariant I3).

Design requirement from LiveR: when the DP degree changes mid-run, the
*global* token stream must be unaffected — only its partitioning across data
ranks changes. We get this by keying every sample counter-style on
``(seed, step, sample_index)`` with a Philox generator, so

    global_batch(step)  is identical for every (dp, pp, tp) decomposition,

and a data-parallel rank's shard is just a slice of it. The iterator state is
exactly ``step`` (checkpointable in O(1); remapped across resizes trivially —
this is the data-plane analogue of the paper's Abstract Resource View).

A Markov "structured" mode gives learnable structure (loss visibly decreases
in the examples); "uniform" mode is for pure-throughput benchmarks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DataState:
    step: int = 0


class SyntheticLM:
    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        mode: str = "structured",  # structured | uniform
    ):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.mode = mode
        # fixed random Markov transition offsets for structured mode
        base = np.random.Generator(np.random.Philox(key=seed))
        self._mults = base.integers(1, 64, size=16)
        self._adds = base.integers(0, vocab_size, size=16)

    # -- core: per-sample counter-based generation ------------------------
    def _sample(self, step: int, idx: int) -> np.ndarray:
        g = np.random.Generator(
            np.random.Philox(key=self.seed + 1, counter=[0, 0, step, idx])
        )
        if self.mode == "uniform":
            return g.integers(0, self.vocab_size, size=self.seq_len, dtype=np.int32)
        # structured: piecewise-affine Markov chain with noise
        pattern = int(g.integers(0, 16))
        x = np.empty(self.seq_len, np.int32)
        x[0] = g.integers(0, self.vocab_size)
        mult, add = int(self._mults[pattern]), int(self._adds[pattern])
        noise = g.integers(0, 4, size=self.seq_len)
        for t in range(1, self.seq_len):
            x[t] = (x[t - 1] * mult + add + noise[t]) % self.vocab_size
        return x

    def global_batch_at(self, step: int) -> np.ndarray:
        return np.stack([self._sample(step, i) for i in range(self.global_batch)])

    def shard_at(self, step: int, dp_rank: int, dp_size: int) -> np.ndarray:
        """The dp_rank-th slice of the global batch — identical global stream
        for every dp_size (elastic invariant, tested)."""
        assert self.global_batch % dp_size == 0, (self.global_batch, dp_size)
        per = self.global_batch // dp_size
        return np.stack(
            [self._sample(step, dp_rank * per + i) for i in range(per)]
        )

    # -- iterator protocol -------------------------------------------------
    def batches(self, state: DataState):
        while True:
            yield self.global_batch_at(state.step)
            state.step += 1
