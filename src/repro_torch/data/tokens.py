"""Synthetic token data (a numpy copy of ``repro.data.tokens``): the
finite ``TokenDataset`` of the LM workloads of a BHFL round
(``make_token_dataset``), and the endless zipf-ish stream of the PoFEL
trainer's launcher (``TokenBatchSpec``, ``synthetic_token_batches``).

Every draw is ``np.random.default_rng(seed)``, as in the reference, so
both packages see the same batches bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class TokenBatchSpec:
    batch: int
    seq_len: int
    vocab_size: int

    def shapes(self) -> dict[str, tuple]:
        return {"tokens": (self.batch, self.seq_len),
                "labels": (self.batch, self.seq_len)}


@dataclass
class TokenDataset:
    """Finite LM dataset: (n, seq_len+1) token rows; batches are
    {tokens, labels} with labels shifted by one.

    Mirrors ``SyntheticImageDataset``'s ``__len__``/``subset``/``batches``
    surface so the FL partitioners (IID) and ``build_hierarchy`` work on
    token data unchanged.
    """

    tokens: np.ndarray      # (n, seq_len + 1) int32
    vocab_size: int

    def __len__(self) -> int:
        return self.tokens.shape[0]

    @property
    def seq_len(self) -> int:
        return self.tokens.shape[1] - 1

    def subset(self, idx: np.ndarray) -> "TokenDataset":
        return TokenDataset(self.tokens[idx], self.vocab_size)

    def batches(self, batch_size: int, seed: int = 0,
                ) -> Iterator[dict[str, np.ndarray]]:
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self))
        for s in range(0, len(self) - batch_size + 1, batch_size):
            sel = order[s:s + batch_size]
            rows = self.tokens[sel]
            yield {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def make_token_dataset(n_seqs: int = 256, seq_len: int = 32,
                       vocab_size: int = 256, seed: int = 0,
                       ) -> tuple[TokenDataset, TokenDataset]:
    """Deterministic zipf-ish (train, test) token datasets for the LM-family
    BHFL workloads (offline stand-in for a real corpus)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    n_test = max(1, n_seqs // 8)
    toks = rng.choice(vocab_size, size=(n_seqs + n_test, seq_len + 1),
                      p=probs).astype(np.int32)
    return (TokenDataset(toks[:n_seqs], vocab_size),
            TokenDataset(toks[n_seqs:], vocab_size))


def synthetic_token_batches(spec: TokenBatchSpec, seed: int = 0,
                            ) -> Iterator[dict[str, np.ndarray]]:
    """Endless {tokens, labels} (batch, seq_len) int32 batches, labels
    shifted by one, from a zipf-like marginal over the vocab."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, spec.vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    while True:
        toks = rng.choice(spec.vocab_size, size=(spec.batch, spec.seq_len + 1),
                          p=probs).astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
