"""The complete BHFL workflow (paper §3.1, all four procedures), driven
through the ``repro_torch.api`` facade — the PyTorch port of
``examples/full_system.py``:

1. Task Publication — a model owner publishes a learning task; nodes
   evaluate and accept (participation constraint).
2. Incentive Mechanism — two-stage Stackelberg game fixes δ* and f_i*.
3. Federated Edge Learning — clusters train with FedAvg.
4. Global Aggregation + PoFEL consensus — HCDS, ME voting, BTSV tally,
   block minting (the five-phase pipeline of ``repro_torch.core.phases``);
   leader + FEL rewards settle per round; the task terminates at target
   loss or max rounds.

``api.run_bhfl`` composes all four; everything it returns (agreement,
reward ledger, runtime/consensus/ledgers, per-round metrics) is inspected
below.

Run:  PYTHONPATH=src python examples_torch/full_system.py [--device cpu]
"""

import argparse

from repro_torch import api, resolve_device

N_NODES = 6


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)     # raises without a card

    # --- 1. Task Publication ------------------------------------------------
    task = api.LearningTask(
        task_id="mnist-mlp-0", publisher_id="model-owner-7",
        description="10-class digit classification, MLP 784-128-10",
        target_loss=1.55, max_rounds=12, block_reward=10.0)
    print(f"published task {task.task_id} (digest {task.digest()[:16]}…)")

    # --- 2-4. negotiation + hierarchy + FEL/consensus rounds -----------------
    run = api.run_bhfl(
        task, model="mlp",
        data=api.make_mnist_like(n_train=4000, n_test=600),
        n_nodes=N_NODES, clients_per_node=4, fel_iterations=2,
        device=device,
        on_round=lambda m: print(f"round {m.round:2d}  leader={m.leader_id}  "
                                 f"acc={m.test_accuracy:.3f}  "
                                 f"loss={m.test_loss:.3f}"))

    agreement = run.agreement
    print(f"negotiated: {len(agreement.participants)} participants, "
          f"δ*={agreement.delta_star:.0f}, "
          f"f*=[{min(agreement.f_star.values()):.1f}.."
          f"{max(agreement.f_star.values()):.1f}]")
    if run.history[-1].test_loss <= task.target_loss:
        print(f"target loss {task.target_loss} reached — task complete")

    # --- settlement -------------------------------------------------------------
    print("\nchain verified:", run.chain_valid, "height:", run.chain_height)
    print("total rewards per node:",
          {i: round(v, 1) for i, v in run.rewards.totals().items()})
    first = agreement.participants[0]
    split = run.rewards.client_split(
        first,
        {c.client_id: float(c.data_size)
         for c in run.runtime.clusters[first].clients})
    print(f"node {first} → client split "
          f"(∝ contribution): {[round(v, 2) for v in split.values()]}")
    return run


if __name__ == "__main__":
    main()
