"""Dry run: build every (architecture × input shape × mesh) step on the
production meshes and emit roofline rows (port of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--json out.json] [--jobs 4]

The reference lowers and compiles each combination on 512 placeholder
XLA devices. Here each setup is built on a fake process group of 512
ranks (``launch.mesh.fake_process_group``), in this one process: its
abstract arguments are DTensors over meta tensors, so nothing is
allocated and nothing is compiled. A row holds the analytic compute and
memory terms at the H100 SXM5 rates (``launch.roofline``), the
collective term: the step's collectives by kind (count and bytes a
device), planned on its abstract arguments at two cut depths and
extrapolated to the full depth (``launch.collectives``), each mesh
axis's bytes over its link's rate (``collective_axes``); the bytes of
one device's shards of every argument (``arg_gb_per_dev``), the useful
share of the FLOPs, ``build_s``; the reference's XLA-only keys
(``raw_cost_*``, ``memory_analysis``, ``lower_s``, ``compile_s``) are
null.
``--device`` (default ``cuda``) is the meshes' device type: the
collective term depends on it, since DTensor moves a tensor from one
sharded dim to another by an all-to-all on a card mesh and by an
all-gather and a chunk on a CPU mesh; nothing else in a row does. Planning the collectives takes most of a combination's
time (0.2-20 s on one core); ``--jobs N`` spreads the combinations over
N processes (each its own fake group), the rows in the same order.
Exits 1 if any combination fails.
"""

import argparse
import contextlib
import io
import json
import os
import time
import traceback

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import INPUT_SHAPES
from repro_torch.launch.collectives import count_collectives
from repro_torch.launch.costs import step_cost
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.launch.roofline import (analyze, axis_links,
                                        model_flops_estimate)
from repro_torch.launch.specs import arg_bytes_per_device, build_setup

LLM_ARCHS = [a for a in ARCH_IDS if a != "mnist-mlp"]
XLA_ONLY = {"lower_s": None, "compile_s": None, "memory_analysis": None}


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def roofline(setup, arch: str, shape_name: str, mesh, multi_pod: bool,
             build):
    """The :class:`~repro_torch.launch.roofline.Roofline` of a built
    setup: analytic costs, one device's argument bytes, and the step's
    collectives (``build(cfg, shape)`` builds the setup again on a cut
    config and shape)."""
    shape = INPUT_SHAPES[shape_name]
    cost = step_cost(setup.model, shape)
    return analyze(arch=arch, shape=shape_name, mesh_name=mesh_name(multi_pod),
                   n_devices=mesh.size(),
                   model_flops=model_flops_estimate(
                       setup.model.n_active_params(), shape.kind,
                       shape.global_batch, shape.seq_len),
                   analytic_flops=cost.flops, analytic_bytes=cost.hbm_bytes,
                   arg_bytes_per_device=arg_bytes_per_device(
                       setup.abstract_args),
                   collectives=count_collectives(setup, build, shape),
                   links=axis_links(mesh))


def run_one(arch: str, shape_name: str, multi_pod: bool,
            device_type: str = "cuda", verbose: bool = True) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    t0 = time.perf_counter()
    setup = build_setup(arch, shape_name, mesh)
    build_s = time.perf_counter() - t0
    roof = roofline(setup, arch, shape_name, mesh, multi_pod,
                    lambda cfg, shape: build_setup(arch, shape, mesh,
                                                   cfg=cfg))
    row = roof.row()
    row.update(build_s=build_s, **XLA_ONLY)
    if verbose:
        print(f"== {arch} × {shape_name} × {mesh_name(multi_pod)} ==")
        print(f"   build {build_s:.3f}s  args/dev "
              f"{row['arg_gb_per_dev']:.3f} GB")
        print(f"   analytic: flops={roof.flops_global:.3e} "
              f"hbm_bytes={roof.hbm_bytes_global:.3e}")
        print(f"   roofline: compute={roof.compute_s * 1e3:.2f}ms "
              f"memory={roof.memory_s * 1e3:.2f}ms "
              f"collective={roof.collective_s * 1e3:.2f}ms "
              f"{row['collective_counts']} → {roof.dominant}-bound; "
              f"useful={roof.useful_flops_ratio:.2f}")
    return row


def run_combo(combo: tuple, device_type: str, world: int) -> tuple:
    """One (index, arch, shape, multi_pod) combination on this process's
    fake group of ``world`` ranks (made at its first call): (index, row
    or None, failure or None, what it printed)."""
    i, arch, shape, mp = combo
    fake_process_group(world)
    text = io.StringIO()
    row = failure = None
    with contextlib.redirect_stdout(text):
        try:
            row = run_one(arch, shape, mp, device_type)
        except Exception as e:
            failure = (arch, shape, mp, repr(e))
            print(f"!! FAIL {arch} × {shape} × {mesh_name(mp)}: {e}")
            traceback.print_exc(file=text)
    return i, row, failure, text.getvalue()


def heavy_first(combo: tuple) -> tuple:
    """Scheduling order for ``--jobs``: the hybrid's train and prefill
    steps (planned token by token) first, then the other train steps."""
    _, arch, shape, _ = combo
    kind = INPUT_SHAPES[shape].kind
    hybrid = get_config(arch).family == "hybrid"
    return (not (hybrid and kind != "decode"), kind != "train", combo[0])


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
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes to spread the combinations over")
    args = ap.parse_args()
    device_type = resolve_device(args.device).type

    archs = LLM_ARCHS if (args.all or args.arch in (None, "all")) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or args.shape in (None, "all"))
              else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    combos = [(i, *c) for i, c in enumerate(
        (arch, shape, mp) for arch in archs for shape in shapes
        for mp in meshes)]
    # one group of the largest mesh's size; a 16×16 mesh takes its first
    # 256 ranks
    world = 512 if any(meshes) else 256
    jobs = max(1, min(args.jobs, len(combos)))
    if jobs == 1:
        results = [run_combo(c, device_type, world) for c in combos]
    else:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        order = sorted(combos, key=heavy_first)
        with ProcessPoolExecutor(jobs, mp_context=mp.get_context(
                "spawn")) as pool:
            results = sorted(pool.map(run_combo, order,
                                      [device_type] * len(order),
                                      [world] * len(order)))
    rows, failures = [], []
    for _, row, failure, text in results:
        print(text, end="", flush=True)
        if row is not None:
            rows.append(row)
        if failure is not None:
            failures.append(failure)
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
