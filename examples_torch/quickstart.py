"""Quickstart: the PoFEL consensus in 60 lines, on the ``repro_torch.api``
facade (the PyTorch port of ``examples/quickstart.py``).

Five BCFL nodes train tiny local models, run one full PoFEL round through
the five-phase pipeline (HCDS commit/reveal → ME similarity voting → vote
submission → BTSV tally → block mint), and every ledger ends up with the
same verified block. A phase hook watches the pipeline run — the API for
experiments that tap individual protocol stages. Model Evaluation runs
the CUDA kernels for Eq. 1 and Eq. 2 on the card.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch import api, resolve_device
from repro_torch.models.mlp import MLPConfig, mlp_init

N_NODES = 5


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)     # raises without a card

    # 1. Each edge server trained an intermediate FEL model (here: random
    #    init + a node-specific perturbation standing in for local training).
    cfg = MLPConfig(hidden=32)
    base = mlp_init(cfg, torch.Generator().manual_seed(0), device=device)
    #    The draws go to the leaves in sorted-name order, as a pytree map.
    rng = np.random.default_rng(0)
    models = [
        {k: base[k] + torch.from_numpy(
            0.01 * rng.normal(size=tuple(base[k].shape))
            .astype(np.float32)).to(device)
         for k in sorted(base)}
        for _ in range(N_NODES)
    ]
    data_sizes = [100.0, 150.0, 120.0, 80.0, 200.0]   # |DS_m| per cluster

    # 2. One PoFEL consensus round (Alg. 1) — five phases over a RoundContext.
    consensus = api.PoFELConsensus(N_NODES)
    print("phases:", [p.name for p in consensus.phases])
    consensus.add_phase_hook(
        "*", lambda name, ctx: print(f"  ✓ {name}"), when="after")
    record = consensus.run_round(models, data_sizes)

    print("cosine similarities s_m:", np.round(record.similarities, 5))
    print("votes:", record.votes.tolist())
    print(f"leader e*(k) = node {record.leader_id}")
    print(f"BTS vote weights: "
          f"{np.round(record.btsv.weights.cpu().numpy(), 3)}")

    # 3. Every node's ledger now holds the identical signed block.
    for ledger in consensus.ledgers:
        assert ledger.height == 1 and ledger.verify_chain()
    block = consensus.chain[0]
    print(f"block 0: leader={block.leader_id} "
          f"digest[gw]={block.global_model_digest[:16]}… "
          f"signature valid={block.verify_signature(consensus.public_keys[block.leader_id])}")
    print("all ledgers consistent ✓")

    # 4. The same protocol drives a full learning task in one call:
    #        api.run_bhfl(model="mlp" | "transformer" | "rwkv6", ...)
    #    — see examples_torch/full_system.py and examples_torch/bhfl_train.py.
    #    Fast path: api.run_bhfl(..., engine="batched") runs each round's
    #    FEL phase as vmapped steps (repro_torch.fl.batched_fel).
    return record, consensus


if __name__ == "__main__":
    main()
