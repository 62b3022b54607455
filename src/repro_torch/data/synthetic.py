"""Deterministic synthetic datasets.

The paper trains on MNIST (28×28 grayscale, 10 classes). This container is
offline, so ``make_mnist_like`` synthesizes a drop-in replacement: each
class is a fixed random template in R^784 plus per-sample gaussian noise,
scaled to [0, 1]. An MLP separates the classes with the same qualitative
learning dynamics (loss ↓, accuracy ↑), which is what the paper's
experiments need (convergence, leader-randomness under IID/non-IID).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticImageDataset:
    x: np.ndarray       # (n, 784) float32 in [0, 1]
    y: np.ndarray       # (n,) int32 labels
    n_classes: int

    def __len__(self) -> int:
        return self.x.shape[0]

    def subset(self, idx: np.ndarray) -> "SyntheticImageDataset":
        return SyntheticImageDataset(self.x[idx], self.y[idx], self.n_classes)

    def batches(self, batch_size: int, seed: int = 0):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self))
        for s in range(0, len(self) - batch_size + 1, batch_size):
            sel = order[s:s + batch_size]
            yield self.x[sel], self.y[sel]


def make_mnist_like(n_train: int = 6000, n_test: int = 1000, n_classes: int = 10,
                    dim: int = 784, noise: float = 0.35, seed: int = 0,
                    ) -> tuple[SyntheticImageDataset, SyntheticImageDataset]:
    """MNIST-shaped synthetic classification data (class templates + noise)."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(0.0, 1.0, size=(n_classes, dim)).astype(np.float32)

    def gen(n: int, s: int) -> SyntheticImageDataset:
        r = np.random.default_rng(s)
        y = r.integers(0, n_classes, size=n).astype(np.int32)
        x = templates[y] + r.normal(0.0, noise, size=(n, dim)).astype(np.float32)
        # squash into [0, 1] like pixel intensities
        x = 1.0 / (1.0 + np.exp(-x))
        return SyntheticImageDataset(x.astype(np.float32), y, n_classes)

    return gen(n_train, seed + 1), gen(n_test, seed + 2)
