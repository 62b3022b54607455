"""Hillclimb driver: build one (arch × shape) under a named sharding
profile and forward-option variant and report its roofline row (port of
``repro.launch.hillclimb``).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch yi-6b --shape train_4k --profile zero3 [--json perf.json]

As the dry run (``launch.dryrun``), the setup is built on a fake process
group, nothing allocated or compiled. ``--override key=value`` sets a
``FwdOptions`` field of a train step; the row records it. The row's
collective term is the step's planned collectives, as the dry run's.
"""

import argparse
import json
import os
import time

from repro_torch import resolve_device
from repro_torch.configs.shapes import INPUT_SHAPES
from repro_torch.launch.dryrun import XLA_ONLY, mesh_name, roofline
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.launch.specs import (build_decode_setup, build_prefill_setup,
                                      build_train_setup,
                                      default_profile_config)


def run(arch: str, shape_name: str, profile: str, multi_pod: bool = False,
        opts_overrides: dict | None = None,
        device_type: str = "cuda") -> dict:
    fake_process_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)

    def build(cfg=None, shape=INPUT_SHAPES[shape_name]):
        if shape.kind == "train":
            tcfg, opts = default_profile_config(profile, mesh)
            if opts_overrides:
                opts = opts._replace(**opts_overrides)
            return build_train_setup(arch, mesh, shape, tcfg, opts,
                                     profile=profile, cfg=cfg)
        if shape.kind == "prefill":
            return build_prefill_setup(arch, mesh, shape, profile=profile,
                                       cfg=cfg)
        return build_decode_setup(arch, mesh, shape, profile=profile,
                                  cfg=cfg)

    t0 = time.perf_counter()
    setup = build()
    build_s = time.perf_counter() - t0
    roof = roofline(setup, arch, shape_name, mesh, multi_pod, build)
    row = roof.row()
    row.update(profile=profile, build_s=build_s,
               opts_overrides=opts_overrides or {}, **XLA_ONLY)
    print(f"== {arch} × {shape_name} × {profile} "
          f"{opts_overrides or ''} (build {build_s:.2f}s) ==")
    print(f"   compute={roof.compute_s:.3f}s memory={roof.memory_s:.3f}s "
          f"collective={roof.collective_s:.3f}s → {roof.dominant}-bound; "
          f"args/dev {row['arg_gb_per_dev']:.3f} GB")
    print(f"   collectives: {row['collective_counts']} over "
          f"{row['collective_axes']}")
    return row


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "sp_attn", "zero3", "serve_tp"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--override", action="append", default=[],
                    help="FwdOptions override key=value (e.g. remat=False)")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (default: the card)")
    args = ap.parse_args()
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=")
        overrides[k] = {"True": True, "False": False}.get(v, v)
    row = run(args.arch, args.shape, args.profile, args.multi_pod,
              overrides or None, resolve_device(args.device).type)
    if args.json:
        rows = []
        if os.path.exists(args.json):
            with open(args.json) as f:
                rows = json.load(f)
        rows.append(row)
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1, default=str)


if __name__ == "__main__":
    main()
