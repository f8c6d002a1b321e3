"""Deterministic synthetic LM data — reproducible across restarts: the
counterpart of ``repro.data.synthetic``, in numpy as there, so its
batches are bit-identical to the reference's.

The stream is indexed by step, so resuming from a checkpoint at step k
regenerates exactly the batches k, k+1, ... (data-state fault tolerance
without storing cursor files).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frames_dim: int = 0          # encdec: also emit frame embeddings

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        r = np.random.default_rng((self.seed, step))
        # Markov-ish stream: mixture of a few "topics" so loss actually falls
        base = r.integers(0, self.vocab, (self.global_batch, 1))
        drift = r.integers(0, max(self.vocab // 64, 2),
                           (self.global_batch, self.seq_len))
        tokens = (base + np.cumsum(drift, axis=1)) % self.vocab
        tokens = tokens.astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((self.global_batch, 1), -1, np.int32)],
            axis=1)
        out = {"tokens": tokens, "labels": labels}
        if self.frames_dim:
            out["frames"] = r.standard_normal(
                (self.global_batch, self.seq_len, self.frames_dim)
            ).astype(np.float32)
        return out

    def iter_from(self, step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step)
            step += 1
