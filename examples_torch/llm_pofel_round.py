"""PoFEL at LLM scale (reduced configs) on the PyTorch port, the
counterpart of ``examples/llm_pofel_round.py``: the consensus trainer
from ``repro_torch.fl.pofel_trainer`` runs real rounds — per-cluster
FedSGD on divergent replicas, Eq. 1/Eq. 2 consensus, BTSV leader
election, and a host-side ledger — for any assigned architecture. On the
card the layers run the wkv6 or flash-attention kernels forward and
backward, and the consensus the Eq. 1 and Eq. 2 kernels.

Run:  PYTHONPATH=src python examples_torch/llm_pofel_round.py [--arch rwkv6-1.6b] [--device cpu]
"""

import argparse

from repro_torch import resolve_device
from repro_torch.launch.train import train_reduced


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--outer", default="nesterov", choices=["sgd1", "nesterov"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)     # raises without a card
    return train_reduced(args.arch, steps=args.steps, n_clusters=4, batch=8,
                         seq=64, seed=0, outer=args.outer, device=device)


if __name__ == "__main__":
    main()
