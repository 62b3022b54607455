"""The one traffic generator: a pool of batches drawn from a seed.

A traffic file (``perfbench/traffic/<name>.json``) gives the round's
shape: ``clusters`` C, ``seqs_per_cluster``, ``seq_len``, ``pool`` (how
many distinct batches the window cycles through), ``context_std`` (the
spread of the conditioning frames a model with cross-attention reads)
and the trainer's settings. Tokens follow the PoFEL launcher's stream (a
copy of ``repro_torch.data.tokens.synthetic_token_batches``): each batch
is (C · seqs_per_cluster, seq_len + 1) draws from a zipf-like marginal
over the vocabulary, labels the tokens shifted by one. A model with
cross-attention gets with each batch its conditioning context, one
sequence of ``n_context_tokens`` frames of width ``d_model`` a row,
drawn on the device as a normal of standard deviation ``context_std``
in bfloat16 (it stands in for the text encoder's projected output, so
every frame differs). Every seed gets the same sizes; only the draws
differ.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def zipf_probs(vocab: int) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    return probs / probs.sum()


def context_seed(seed: int) -> int:
    """The device generator's seed for the contexts, apart from the
    weights' (``seed``) and the replicas' streams."""
    return 4 * seed + 1


def token_pool(seed: int, traffic: dict, arch: dict, device) -> List[dict]:
    """``traffic["pool"]`` batches of {tokens, labels}, each int32
    (C · seqs_per_cluster, seq_len) on the host, drawn from ``seed``;
    for a model with cross-attention also ``context`` (C ·
    seqs_per_cluster, n_context_tokens, d_model), bfloat16 on
    ``device``."""
    rng = np.random.default_rng(seed)
    vocab = arch["vocab_size"]
    probs = zipf_probs(vocab)
    rows = traffic["clusters"] * traffic["seqs_per_cluster"]
    pool = []
    for _ in range(traffic["pool"]):
        toks = rng.choice(vocab, size=(rows, traffic["seq_len"] + 1),
                          p=probs).astype(np.int32)
        pool.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    if arch.get("n_context_tokens"):
        gen = torch.Generator(device=torch.device(device)).manual_seed(
            context_seed(seed))
        ctx = torch.randn((len(pool), rows, arch["n_context_tokens"],
                           arch["d_model"]), generator=gen,
                          device=gen.device, dtype=torch.float32)
        ctx = (ctx * traffic["context_std"]).to(torch.bfloat16)
        for b, c in zip(pool, ctx.unbind(0)):
            b["context"] = c
    return pool


def cluster_slices(batch: dict, clusters: int) -> List[dict]:
    """A pool batch as the clusters see it: cluster c takes rows
    [c · B/C, (c + 1) · B/C), as the launcher's reshape to (C, B/C, S)."""
    n = batch["tokens"].shape[0] // clusters
    return [{k: v[c * n:(c + 1) * n] for k, v in batch.items()}
            for c in range(clusters)]
