"""Dry run: build every (architecture × input shape × mesh) step on the
production meshes and emit roofline rows (port of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--json out.json]

The reference lowers and compiles each combination on 512 placeholder
XLA devices. Here each setup is built on a fake process group of 512
ranks (``launch.mesh.fake_process_group``), in this one process: its
abstract arguments are DTensors over meta tensors, so nothing is
allocated and nothing is compiled. A row holds the analytic compute and
memory terms at the H100 SXM5 rates (``launch.roofline``), the bytes of
one device's shards of every argument (``arg_gb_per_dev``), the useful
share of the FLOPs, ``build_s``; the reference's XLA-only keys
(``raw_cost_*``, ``memory_analysis``, ``lower_s``, ``compile_s``) are
null, and ``collective_s`` is null with ``collective_note`` saying why.
``--device`` (default ``cuda``) is the meshes' device type: the rows do
not depend on it. Exits 1 if any combination fails.
"""

import argparse
import json
import os
import time
import traceback

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS
from repro_torch.configs.shapes import INPUT_SHAPES
from repro_torch.launch.costs import step_cost
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.launch.roofline import analyze, model_flops_estimate
from repro_torch.launch.specs import arg_bytes_per_device, build_setup

LLM_ARCHS = [a for a in ARCH_IDS if a != "mnist-mlp"]
XLA_ONLY = {"lower_s": None, "compile_s": None, "memory_analysis": None}


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def roofline(setup, arch: str, shape_name: str, mesh, multi_pod: bool):
    """The :class:`~repro_torch.launch.roofline.Roofline` of a built
    setup: analytic costs, one device's argument bytes."""
    shape = INPUT_SHAPES[shape_name]
    cost = step_cost(setup.model, shape)
    return analyze(arch=arch, shape=shape_name, mesh_name=mesh_name(multi_pod),
                   n_devices=mesh.size(),
                   model_flops=model_flops_estimate(
                       setup.model.n_active_params(), shape.kind,
                       shape.global_batch, shape.seq_len),
                   analytic_flops=cost.flops, analytic_bytes=cost.hbm_bytes,
                   arg_bytes_per_device=arg_bytes_per_device(
                       setup.abstract_args))


def run_one(arch: str, shape_name: str, multi_pod: bool,
            device_type: str = "cuda", verbose: bool = True) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    t0 = time.perf_counter()
    setup = build_setup(arch, shape_name, mesh)
    build_s = time.perf_counter() - t0
    roof = roofline(setup, arch, shape_name, mesh, multi_pod)
    row = roof.row()
    row.update(build_s=build_s, **XLA_ONLY)
    if verbose:
        print(f"== {arch} × {shape_name} × {mesh_name(multi_pod)} ==")
        print(f"   build {build_s:.3f}s  args/dev "
              f"{row['arg_gb_per_dev']:.3f} GB")
        print(f"   analytic: flops={roof.flops_global:.3e} "
              f"hbm_bytes={roof.hbm_bytes_global:.3e}")
        print(f"   roofline: compute={roof.compute_s * 1e3:.2f}ms "
              f"memory={roof.memory_s * 1e3:.2f}ms collective: "
              f"{row['collective_note']} → {roof.dominant}-bound; "
              f"useful={roof.useful_flops_ratio:.2f}")
    return row


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=LLM_ARCHS + ["all"])
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + ["all"])
    ap.add_argument("--all", action="store_true",
                    help="all arch × shape combos")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", default=None, help="append JSON rows here")
    ap.add_argument("--device", default="cuda",
                    help="the meshes' device type (default: the card)")
    args = ap.parse_args()
    device_type = resolve_device(args.device).type

    archs = LLM_ARCHS if (args.all or args.arch in (None, "all")) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or args.shape in (None, "all"))
              else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    # one group of the largest mesh's size; a 16×16 mesh takes its first
    # 256 ranks
    fake_process_group(512 if any(meshes) else 256)

    rows, failures = [], []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rows.append(run_one(arch, shape, mp, device_type))
                except Exception as e:
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"!! FAIL {arch} × {shape} × {mesh_name(mp)}: {e}")
                    traceback.print_exc()
    if args.json:
        existing = []
        if os.path.exists(args.json):
            with open(args.json) as f:
                existing = json.load(f)
        existing.extend(rows)
        with open(args.json, "w") as f:
            json.dump(existing, f, indent=1, default=str)
    print(f"\n{len(rows)} combos OK, {len(failures)} failed")
    if failures:
        for f_ in failures:
            print("  FAILED:", f_)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
