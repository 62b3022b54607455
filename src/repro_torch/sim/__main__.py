"""``python -m repro_torch.sim`` — the scenario-runner CLI (see sim.runner)."""

import sys

from repro_torch.sim.runner import main

sys.exit(main())
