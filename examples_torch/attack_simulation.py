"""Adversary simulation (paper §3.2 + §7.4) on the PyTorch port — a thin
wrapper over the ``repro_torch.sim`` scenario registry, the counterpart
of ``examples/attack_simulation.py``:

1. Model plagiarism — a BCFL node copies a peer's FEL model; HCDS
   rejects the duplicate reveal every round.
2. Bribery voting — colluding nodes vote a fixed target (TA) or randomly
   (RA); BTSV down-weights them and the honest argmax keeps winning.

Run:  PYTHONPATH=src python examples_torch/attack_simulation.py [--device cpu]

Add your own attacks by registering a ``sim.Scenario`` with adversaries
from ``repro_torch.sim.adversary``.
"""

import argparse

from repro_torch import resolve_device, sim


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)     # raises without a card

    reports = {}
    for name in ("plagiarist", "bribery_targeted", "bribery_random"):
        sc = sim.get_scenario(name)
        print(f"=== {name} ===\n    {sc.description}")
        report = sim.run_scenario(name, seed=0, device=device)
        reports[name] = report
        print(f"    {report.summary()}")
        assert report.liveness and report.safety_violations == 0

        if name == "plagiarist":
            plag = sc.adversaries[0].node_id
            reasons = {r.round: r.rejected.get(plag) for r in report.rounds}
            print(f"    plagiarist node {plag} rejected: {reasons}")
            assert all(v == "plagiarized-model" for v in reasons.values())
            assert report.honest_leader_rate == 1.0
        else:
            # the bribed votes never displaced the honest similarity argmax
            assert report.argmax_leader_rate == 1.0

    print("\nHCDS + BTSV suppressed all three attacks ✓")
    return reports


if __name__ == "__main__":
    main()
