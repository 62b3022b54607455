"""Client data partitioners (paper §7.1 / §7.3).

- IID: uniform random split ("data with all labels available to each client")
- label-limited non-IID: each client sees a fixed subset of labels
  (the paper's non-IID: "roughly six out of ten labels" per client)
- Dirichlet non-IID: standard FL benchmark partition, for extra coverage
"""

from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.data.synthetic import SyntheticImageDataset


def partition_iid(ds: SyntheticImageDataset, n_parts: int, seed: int = 0,
                  ) -> List[SyntheticImageDataset]:
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(ds))
    return [ds.subset(chunk) for chunk in np.array_split(order, n_parts)]


def partition_label_limited(ds: SyntheticImageDataset, n_parts: int,
                            labels_per_part: int = 6, seed: int = 0,
                            ) -> List[SyntheticImageDataset]:
    """Paper's non-IID: each partition draws only from `labels_per_part` labels."""
    rng = np.random.default_rng(seed)
    by_label = {c: np.flatnonzero(ds.y == c) for c in range(ds.n_classes)}
    for idx in by_label.values():
        rng.shuffle(idx)
    cursors = {c: 0 for c in by_label}
    target = len(ds) // n_parts
    parts: List[SyntheticImageDataset] = []
    for p in range(n_parts):
        labels = rng.choice(ds.n_classes, size=labels_per_part, replace=False)
        take_each = max(1, target // labels_per_part)
        sel: list[np.ndarray] = []
        for c in labels:
            pool = by_label[c]
            start = cursors[c]
            got = pool[start:start + take_each]
            if len(got) < take_each:  # wrap around if a label pool is exhausted
                got = np.concatenate([got, pool[: take_each - len(got)]])
                cursors[c] = take_each - len(got)
            else:
                cursors[c] = start + take_each
            sel.append(got)
        parts.append(ds.subset(np.concatenate(sel)))
    return parts


def partition_dirichlet(ds: SyntheticImageDataset, n_parts: int,
                        alpha: float = 0.5, seed: int = 0,
                        ) -> List[SyntheticImageDataset]:
    rng = np.random.default_rng(seed)
    idx_parts: list[list[int]] = [[] for _ in range(n_parts)]
    for c in range(ds.n_classes):
        idx = np.flatnonzero(ds.y == c)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_parts)
        bounds = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for p, chunk in enumerate(np.split(idx, bounds)):
            idx_parts[p].extend(chunk.tolist())
    return [ds.subset(np.asarray(sorted(p), dtype=np.int64)) for p in idx_parts]
