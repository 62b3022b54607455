#!/usr/bin/env python3
"""Time the wkv6 backward kernel of one or more checkouts on one card.

    python3 tools/time_wkv6_backward.py ROOT [ROOT ...]

For each ROOT (the root of a checkout of this repository, or of a copy
of it with an edited kernel), a fresh process puts ROOT/src first on the
path, builds that checkout's kernels from its own sources and times
``wkv6_backward`` with ``chip_smoke.graph_time_us`` (CUDA events over
CUDA-graph replays, median of 50) at ``chip_smoke.WKV6_BWD_SHAPES`` and
the full-width FedSGD step's (4, 512, 32, 64), beside its largest
absolute difference from the checkout's plain version. It prints one
JSON line a root. Quicker than ``tools/kernel_ab.py`` when only this
kernel changed; needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def time_checkout(root: Path) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import wkv6 as kw
    assert Path(_build.__file__).resolve().is_relative_to(root.resolve())
    _build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for B, S, H, K in cs.WKV6_BWD_SHAPES + ((4, 512, 32, 64),):
        args = cs.wkv6_inputs(gen, dev, B, S, H, K, "mid")
        d_o = torch.randn(B, S, H, K, generator=gen, device=dev)
        d_state = 0.1 * torch.randn(B, H, K, K, generator=gen, device=dev)
        _, _, ckpt = kw._forward(*args, save=True)

        def bwd():
            return kw.wkv6_backward(*args, d_o, d_state, ckpt)
        want = ref.wkv6_backward_ref(*args, d_o, d_state)
        out[f"{(B, S, H, K)} max_abs_err"] = max(
            float((a - b).abs().max()) for a, b in zip(bwd(), want))
        del want
        out[str((B, S, H, K))] = cs.graph_time_us(bwd)
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(time_checkout(Path(sys.argv[2]))))
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in sys.argv[1:]:
        res = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        print(root, res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
