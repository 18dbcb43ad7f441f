"""Deterministic synthetic LM data with document packing.

The port's own copy of ``repro/data/pipeline.py`` (numpy only; the port
imports nothing of ``repro``). It gives the same batches bit for bit.

Determinism contract: the batch for global step ``s`` is a pure function
of ``(seed, s)``, so a resumed run regenerates identical data and
checkpoint-resume is bitwise reproducible.

Packing (paper §A.4.2): several documents share each row; ``resets``
marks document starts, which linear-attention layers turn into state
resets (``RESET_LOG_A``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    pack_documents: bool = True
    mean_doc_len: int = 512

    def batch(self, step: int) -> dict:
        """Batch for one global step: tokens/labels (B, S) int32,
        resets (B, S) bool. Labels are next-token; last position = -1."""
        rng = np.random.default_rng([self.seed, step])
        b, s = self.global_batch, self.seq_len
        # power-law unigram skew: entropy well below ln(V), so the loss
        # visibly falls during training
        u = rng.random((b, s + 1))
        tokens = np.minimum((self.vocab_size * u ** 4).astype(np.int32),
                            self.vocab_size - 1)
        resets = np.zeros((b, s + 1), bool)
        resets[:, 0] = True
        if self.pack_documents:
            n_docs = max(1, s // self.mean_doc_len)
            for i in range(b):
                cuts = np.sort(rng.choice(
                    np.arange(1, s), size=n_docs - 1, replace=False)) \
                    if n_docs > 1 else np.array([], np.int64)
                resets[i, cuts] = True
        # learnable structure: the third quarter of each row repeats its
        # first quarter
        rep = s // 4
        tokens[:, 2 * rep:3 * rep] = tokens[:, :rep]
        labels = tokens[:, 1:].copy()
        labels[:, -1] = -1
        return {"tokens": tokens[:, :-1], "labels": labels,
                "resets": resets[:, :-1]}

    def microbatched(self, step: int, num_microbatches: int) -> dict:
        """(A, B/A, S)-shaped batch for gradient accumulation."""
        batch = self.batch(step)
        a = num_microbatches
        b = self.global_batch
        if b % a:
            raise ValueError(f"global_batch {b} % microbatches {a} != 0")
        return {k: v.reshape(a, b // a, *v.shape[1:])
                for k, v in batch.items()}


def doc_segments(resets: np.ndarray) -> np.ndarray:
    """Segment ids (B, S) from reset flags."""
    return np.cumsum(resets, axis=1).astype(np.int32)
