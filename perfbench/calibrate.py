"""Readings that a cell's limits are set from, at the cell's own size, on
the card: the numbers compared for the program (sound runs), for the
control (the reference with float8 products in the program's place) and
for the program with a fault planted, over many seeds in one process
(the checked rounds only, no window).

    python3 perfbench/calibrate.py --workload <cell> --mode program \\
        --seeds 11,12,13 [--out readings.jsonl]

``--mode`` is ``program``, ``control`` or one of the faults of
``perfbench.harness.faults``, or several of them with commas between.
Each mode and seed prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from dataclasses import asdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings_of(cell, seed: int, dev, mode: str) -> dict:
    from perfbench.harness import cell as cell_mod
    from perfbench.harness import faults
    arch = cell.config["arch"]
    if mode == "control":
        return cell_mod.control_numbers(cell, seed, dev, arch)
    planted = faults.FAULTS[mode]() if mode != "program" else \
        contextlib.nullcontext()
    with planted:
        prog, pool, readings = cell_mod.set_up(cell, seed, dev, arch)
        readings.blocks = [asdict(b) for b in prog.blocks()]
        readings.chain_verifies = prog.chain_verifies()
    del prog
    cell_mod.free(dev)
    return cell_mod.reference_numbers(cell, seed, dev, arch, pool, readings)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from perfbench.harness.spec import load_cell
    cell = load_cell(args.workload, ROOT)
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    try:
        for mode, seed in ((m, int(s)) for m in args.mode.split(",")
                           for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            numbers = readings_of(cell, seed, dev, mode)
            line = {"workload": args.workload, "mode": mode,
                    "seed": seed, "seconds": time.perf_counter() - t0,
                    "numbers": numbers}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
