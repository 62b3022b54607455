"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout whose ``BENCHMARK.json`` names the cell. The
last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` a ``breakdown``, and last ``checks``: each number compared beside
its limit, which also end standard error. A run without a CUDA card, or
with fewer cards than the cell asks for, exits 2 and prints no result;
one whose process holds JAX or the JAX package once the window has
closed exits 3.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse      # noqa: E402
import json          # noqa: E402
import os            # noqa: E402
import subprocess    # noqa: E402
import sys           # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def since_start() -> float:
    """Seconds since this process started (from /proc, in clock ticks),
    or since this module was loaded where /proc has no answer."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX
    package, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit(index: int = 0) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index),
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = ROOT / "build" / "perfbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)


def result_line(cell, run, numbers: dict, correct: bool, traced: bool,
                kind: str, limit: str) -> dict:
    """The result's line: ``correct``, ``attempted``, ``failed``, the
    metrics the run has readings for, ``device`` (with the traced
    window's busy and total seconds), with a trace the ``breakdown``,
    and last ``checks``, each number compared beside its limit."""
    from perfbench.harness.cell import metric_values
    metrics = metric_values(cell.per_layer if traced else cell.end_to_end,
                            run)
    device = {"platform": "gpu", "kind": kind, "count": 1,
              "memory_peak_bytes": run.peak_bytes, "power_limit": limit}
    result = {"correct": correct, "attempted": run.rounds,
              "failed": run.failed, "metrics": metrics, "device": device}
    if traced and run.device_trace is not None:
        tr = run.device_trace
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top(10),
                               "idle_gaps": run.idle_gaps}
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in numbers.items() if "limit" in v}
    return result


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card and does not "
              "fall back to the CPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from perfbench.harness.cell import run_cell
    from perfbench.harness.spec import load_cell
    cell = load_cell(args.workload, ROOT)
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards; "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    print(f"the card reached at {since_start():.2f} s since the process "
          f"started", file=sys.stderr, flush=True)
    limit = power_limit()
    print(f"card: {limit}", file=sys.stderr, flush=True)
    run, numbers, correct = run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), dev, since_start)
    found = forbidden_modules()
    if found:
        print(f"the process holds {found} after the window", file=sys.stderr)
        return 3
    result = result_line(cell, run, numbers, correct, bool(args.trace),
                         torch.cuda.get_device_name(0), limit)
    for name, c in numbers.items():
        extra = {k: v for k, v in c.items() if k not in ("value", "limit")}
        print(f"check {name}: {c['value']!r} limit "
              f"{c.get('limit', 'not compared')!r}"
              + (f" {extra}" if extra else ""), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
