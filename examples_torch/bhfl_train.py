"""End-to-end driver (paper §7.1 setup) on the PyTorch port — the
counterpart of ``examples/bhfl_train.py``:

Blockchain-based hierarchical FL on synthetic data via ``repro_torch.api``
— N edge clusters × 5 clients each train with FedAvg; every BCFL round
runs the full five-phase PoFEL consensus (HCDS → ME → votes → BTSV →
block) and appends a block. The ``--model`` flag swaps the workload
between the paper's MNIST MLP and the reduced-scale transformer / RWKV6
LMs — same consensus path, different ``ModelAdapter``. On the card Model
Evaluation runs the Eq. 1 and Eq. 2 kernels, and the LMs' layers the
wkv6 or flash-attention kernels forward and backward.

Run:  PYTHONPATH=src python examples_torch/bhfl_train.py [--nodes 8] [--rounds 10]
      PYTHONPATH=src python examples_torch/bhfl_train.py --model rwkv6 --rounds 3
      (add --device cpu to run without a card)
"""

import argparse

from repro_torch import api, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="mlp",
                    choices=["mlp", "transformer", "rwkv6"])
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--fel-iters", type=int, default=3)
    ap.add_argument("--distribution", default="iid",
                    choices=["iid", "label", "dirichlet"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)     # raises without a card

    if args.model == "mlp":
        data = api.make_mnist_like(n_train=6000, n_test=1000)
    else:
        data = api.make_token_dataset(n_seqs=512, seq_len=16, vocab_size=256)
        if args.distribution != "iid":
            ap.error("label-aware partitions need image labels; LM models "
                     "support --distribution iid")

    print(f"BHFL[{args.model}]: {args.nodes} BCFL nodes × {args.clients} "
          f"clients, {args.distribution} data, {args.fel_iters} FEL "
          f"iters/round")
    run = api.run_bhfl(
        model=args.model, data=data,
        n_nodes=args.nodes, clients_per_node=args.clients,
        fel_iterations=args.fel_iters, rounds=args.rounds,
        distribution=args.distribution, device=device,
        on_round=lambda m: print(f"round {m.round:3d}  leader={m.leader_id}  "
                                 f"acc={m.test_accuracy:.3f}  "
                                 f"loss={m.test_loss:.3f}"))

    print("\nleader counts (Fig. 6b):", run.leader_counts)
    assert run.chain_valid
    print(f"chain verified at height {run.chain_height} ✓")
    first, last = run.history[0], run.history[-1]
    print(f"accuracy {first.test_accuracy:.3f} → {last.test_accuracy:.3f}")
    return run


if __name__ == "__main__":
    main()
