"""The steps on a mesh of several ranks, held against one process.

The reference checks its mesh path by building the PoFEL round for five
archs at ``baseline`` (C = 4) and for yi-6b and deepseek-moe-16b at
``zero3`` (C = 2, the clusters over ``data``) on a 2 × 4 mesh of the
reduced configs (``tests/test_sharding_specs.py:test_mini_sharded_lowering``).
Here those seven rounds, and prefill and decode for yi-6b and
deepseek-moe-16b, run as DTensor steps (``launch.specs``) on a (2, 2)
``("data", "model")`` mesh of four CPU processes (``mesh.run_on_ranks``:
gloo, no network), and each is held against the same step in one
process on plain tensors. One more round, yi-6b's at ``zero3_pod``,
runs on a (2, 2, 1) ``("pod", "data", "model")`` mesh of the same four
processes with its C = 4 clusters over ``("pod", "data")``, pod-major:
the two-axis cluster split of the production 2 × 16 × 16 mesh's zero3.


    PYTHONPATH=src python -m repro_torch.launch.mesh_check \\
        [--case yi-6b:zero3 ...] [--no-serve] [--json out.json]

It prints a line a case (seconds on the mesh, collectives by kind, the
largest differences) and exits 1 if a case disagrees. Each case's
collectives are also planned on the same mesh, on its abstract
arguments, moving nothing (``launch.collectives``, the roofline's
count), and the plan must equal what the run issued, kind by kind, in
count and in bytes a device, and axis by axis in bytes. The tolerances
are ``tests/test_torch_pofel_trainer.py``'s: losses within 5e-2, weights
within rtol 1e-2 / atol 1e-3 (bfloat16), similarities within 1e-4 and
the same leader where the top two lie more than 2e-4 apart; logits of
prefill and decode within the weights' rule. The round starts from
replicas made to differ (seeded noise, as that test's), so that the
similarities spread and the leader means something.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Any

import numpy as np
import torch

MESH_SHAPE = (2, 2)
MESH_AXES = ("data", "model")
TRAIN_CASES = (("yi-6b", "baseline"), ("deepseek-moe-16b", "baseline"),
               ("rwkv6-1.6b", "baseline"), ("zamba2-7b", "baseline"),
               ("musicgen-medium", "baseline"), ("yi-6b", "zero3"),
               ("deepseek-moe-16b", "zero3"))
POD_CASES = (("yi-6b", "zero3_pod"),)
POD_MESH_SHAPE = (2, 2, 1)
POD_MESH_AXES = ("pod", "data", "model")
SERVE_CASES = (("yi-6b", "prefill"), ("yi-6b", "decode"),
               ("deepseek-moe-16b", "prefill"),
               ("deepseek-moe-16b", "decode"))
SEQ, BATCH = 64, 8                 # the reference's mini train shape
SERVE_SEQ, SERVE_BATCH = 64, 4
LOSS_TOL = 5e-2
WEIGHT_TOL = dict(rtol=1e-2, atol=1e-3)
SIM_ATOL = 1e-4
DIVERGE = (0.15, 0.03, 0.09, 0.21)   # a replica's noise, relative to rms


@contextlib.contextmanager
def reduced_configs():
    """``launch.specs`` building on the reduced configs, as the
    reference's mini test patches its ``get_config``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    real = specs.get_config
    specs.get_config = lambda arch: get_config(arch).reduced()
    try:
        yield
    finally:
        specs.get_config = real


def train_config(profile: str):
    """(PoFELTrainConfig, FwdOptions) of a mini case: the reference's
    mini test's (remat off; zero3's levers all on, C = 2 over data;
    zero3_pod's the same with C = 4 over pod and data)."""
    from repro_torch.fl import pofel_trainer as pt
    from repro_torch.models.transformer import FwdOptions
    if profile in ("zero3", "zero3_pod"):
        pod = profile == "zero3_pod"
        return (pt.PoFELTrainConfig(n_clusters=4 if pod else 2,
                                    cluster_axis=(POD_MESH_AXES[:2] if pod
                                                  else "data"),
                                    inner_lr=1e-2),
                FwdOptions(remat=False, seq_shard_axis="model", dp_axes=(),
                           parallel_q=True, gather_kv=True,
                           weight_gather=True, expert_axis="model"))
    return (pt.PoFELTrainConfig(n_clusters=4, inner_lr=1e-2),
            FwdOptions(remat=False))


def _diverged(cluster_params: Any, seed: int = 1) -> Any:
    """Each replica with seeded noise of relative size DIVERGE[c] of the
    leaf's rms (at least 1e-2), added in float32, in the leaf's dtype."""
    from repro_torch.core.serialization import leaves_with_paths, rebuild
    rng = np.random.default_rng(seed)

    def leaf(t):
        x = t.to(torch.float32)
        rms = max(float(torch.sqrt(torch.mean(x[0] ** 2))), 1e-2)
        scale = torch.tensor(DIVERGE[:t.shape[0]], device=t.device).reshape(
            (-1,) + (1,) * (t.ndim - 1)) * rms
        noise = torch.from_numpy(rng.standard_normal(
            tuple(t.shape), dtype=np.float32)).to(t.device)
        return (x + scale * noise).to(t.dtype)

    return rebuild(cluster_params, {p: leaf(t) for p, t in
                                    leaves_with_paths(cluster_params)})


def train_inputs(arch: str, profile: str, mesh) -> tuple:
    """(setup, state, batch, λ) of a train case, plain and whole, on the
    mesh's device type: the same on every rank and in one process."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.fl import pofel_trainer as pt
    from repro_torch.launch import specs
    tcfg, opts = train_config(profile)
    with reduced_configs():
        setup = specs.build_train_setup(
            arch, mesh, InputShape("mini_train", SEQ, BATCH, "train"), tcfg,
            opts, profile=profile.removesuffix("_pod"))
    model, C, dev = setup.model, tcfg.n_clusters, setup.model.device
    state = pt.init_train_state(
        model, tcfg, torch.Generator(device=dev).manual_seed(0))
    state = state._replace(cluster_params=_diverged(state.cluster_params))
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(
        0, model.cfg.vocab_size, (C, BATCH // C, SEQ)).astype(np.int32))
    batch = {"tokens": tok.to(dev), "labels": tok.roll(1, -1).to(dev)}
    if model.needs_context():
        batch["context"] = 0.1 * torch.ones(
            (C, BATCH // C, model.cfg.n_context_tokens, model.cfg.d_model),
            dtype=torch.bfloat16, device=dev)
    lam = torch.arange(1, C + 1, dtype=torch.float32, device=dev)
    return setup, state, batch, lam


def serve_inputs(arch: str, kind: str, mesh) -> tuple:
    """(setup, arguments) of a prefill or decode case, plain and whole."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import specs
    shape = InputShape(f"mini_{kind}", SERVE_SEQ, SERVE_BATCH, kind)
    with reduced_configs():
        build = (specs.build_prefill_setup if kind == "prefill"
                 else specs.build_decode_setup)
        setup = build(arch, mesh, shape)
    model = setup.model
    params = model.init(torch.Generator().manual_seed(0))
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (SERVE_BATCH, SERVE_SEQ)).astype(np.int32))
    if kind == "prefill":
        return setup, (params, {"tokens": tok})
    return setup, (params, model.init_cache(SERVE_BATCH, SERVE_SEQ),
                   tok[:, :1], torch.tensor(SERVE_SEQ // 2,
                                            dtype=torch.int32))


def _whole(tree: Any) -> Any:
    """Every DTensor of a tree (dicts, NamedTuples, tuples) as its full
    plain tensor, detached."""
    from repro_torch.models.mesh_ops import whole
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_whole(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            tuple(items)
    if isinstance(tree, torch.Tensor):
        return whole(tree).detach()
    return tree


def _outputs(case: tuple, out: tuple) -> dict:
    """What a case's step gave, whole: the train step's global params,
    losses, similarities, leader and history, or the logits."""
    if case[1] in ("prefill", "decode"):
        return {"logits": _whole(out[0])}
    state, metrics = _whole(out)
    return {"global": state.global_params, "loss": metrics.loss,
            "sims": metrics.similarities, "leader": int(metrics.leader),
            "history": state.btsv_history}


def run_case(case: tuple, mesh) -> dict:
    """A case's step on ``mesh`` with DTensor arguments: its outputs,
    seconds, collectives by op (``CommDebugMode``), and by kind, count,
    bytes and axis as the run issued them (``measured``) and as the
    step's plan counts them (``planned``)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch import specs
    from repro_torch.launch.collectives import CollectiveCounter, plan_step
    arch, kind = case
    if kind in ("prefill", "decode"):
        setup, plain = serve_inputs(arch, kind, mesh)
    else:
        setup, *plain = train_inputs(arch, kind, mesh)
    args = [specs.distribute_like(v, a)
            for v, a in zip(plain, setup.abstract_args)]
    t0 = time.perf_counter()
    with CommDebugMode() as comm, CollectiveCounter(mesh) as measured:
        out = setup.step(*args)
    seconds = time.perf_counter() - t0
    counts = {getattr(op, "_qualified_op_name", str(op)): n
              for op, n in comm.get_comm_counts().items()}
    planned = plan_step(setup)        # the reduced configs' full depth
    return {"outputs": _outputs(case, out), "seconds": seconds,
            "collectives": counts, "measured": measured.stats.as_dict(),
            "planned": planned.as_dict()}


def case_mesh(case: tuple, host: bool = False):
    """The mesh a case runs on: (2, 2) ``("data", "model")``, or (2, 2,
    1) ``("pod", "data", "model")`` for a ``POD_CASES`` one; with
    ``host``, the same axes of size 1 on a world-size-1 group."""
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    pod = case[1].endswith("_pod")
    if host:
        mesh = make_host_mesh("cpu")        # the group, if there is none
        if not pod:
            return mesh
    shape, names = ((POD_MESH_SHAPE, POD_MESH_AXES) if pod
                    else (MESH_SHAPE, MESH_AXES))
    return make_mesh((1,) * len(shape) if host else shape, names)


def run_single(case: tuple) -> dict:
    """A case's step in this process on plain tensors (a 1 × 1 mesh's
    one-card path): its outputs."""
    mesh = case_mesh(case, host=True)
    arch, kind = case
    if kind in ("prefill", "decode"):
        setup, plain = serve_inputs(arch, kind, mesh)
    else:
        setup, *plain = train_inputs(arch, kind, mesh)
    return _outputs(case, setup.step(*plain))


def on_ranks(cases: tuple, repeat: tuple) -> list:
    """One rank's part of :func:`run_on_mesh`: each case on its mesh
    (:func:`case_mesh`), then ``repeat`` again; rank 0 returns the
    results."""
    import torch.distributed as dist
    meshes = {}

    def run(case):
        key = case[1].endswith("_pod")
        if key not in meshes:
            meshes[key] = case_mesh(case)
        return run_case(case, meshes[key])
    results = [run(tuple(c)) for c in cases]
    again = run(tuple(repeat)) if repeat else None
    return (results, again) if dist.get_rank() == 0 else None


def run_on_mesh(cases: tuple, repeat: tuple = (),
                timeout: float = 600.0) -> tuple:
    """Every case on its mesh of four local CPU processes, in one
    call: (results a case, the repeated case's second result or None)."""
    from repro_torch.launch.mesh import run_on_ranks
    return run_on_ranks(on_ranks, 4, tuple(cases), tuple(repeat),
                        timeout=timeout)[0]


def _max_err(a, b) -> float:
    return float((a.to(torch.float32) - b.to(torch.float32)).abs().max())


def _tree_pairs(a: Any, b: Any):
    from repro_torch.core.serialization import leaves_with_paths
    return zip(leaves_with_paths(a), leaves_with_paths(b))


def differences(mesh: dict, single: dict) -> dict:
    """The largest differences of a case's mesh outputs from its single
    process ones, and ``within``: whether each lies within the
    tolerances (the leader only where the top two are clear)."""
    out, ok = {}, {}
    if "logits" in single:
        a, b = mesh["logits"], single["logits"]
        out["logits"] = _max_err(a, b)
        ok["logits"] = bool(torch.allclose(a.float(), b.float(),
                                           **WEIGHT_TOL))
        return {**out, "within": ok}
    out["loss"] = _max_err(mesh["loss"], single["loss"])
    ok["loss"] = out["loss"] <= LOSS_TOL
    out["sims"] = _max_err(mesh["sims"], single["sims"])
    ok["sims"] = out["sims"] <= SIM_ATOL
    out["weights"], ok["weights"] = 0.0, True
    for (path, a), (_, b) in _tree_pairs(mesh["global"], single["global"]):
        out["weights"] = max(out["weights"], _max_err(a, b))
        ok["weights"] &= bool(torch.allclose(a.float(), b.float(),
                                             **WEIGHT_TOL))
    out["history"] = _max_err(mesh["history"], single["history"])
    ok["history"] = out["history"] <= SIM_ATOL
    top = torch.sort(single["sims"], descending=True).values
    out["margin"] = float(top[0] - top[1])
    ok["leader"] = (out["margin"] <= 2 * SIM_ATOL
                    or mesh["leader"] == single["leader"])
    return {**out, "within": ok}


def bit_identical(a: dict, b: dict) -> bool:
    """Whether two results of one case have the same bits."""
    from repro_torch.core.serialization import leaves_with_paths
    la, lb = leaves_with_paths(a["outputs"]), leaves_with_paths(b["outputs"])
    return len(la) == len(lb) and all(
        pa == pb and (torch.equal(x, y) if isinstance(x, torch.Tensor)
                      else x == y) for (pa, x), (pb, y) in zip(la, lb))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", action="append", default=[],
                    help="arch:profile (baseline, zero3, zero3_pod) or "
                         "arch:prefill, arch:decode; default the seven "
                         "train cases, the pod case and the four serving "
                         "cases")
    ap.add_argument("--no-serve", action="store_true",
                    help="without the default prefill and decode cases")
    ap.add_argument("--json", help="append the rows to this JSON file")
    args = ap.parse_args(argv)
    cases = [tuple(c.split(":")) for c in args.case] or (
        list(TRAIN_CASES) + list(POD_CASES)
        + ([] if args.no_serve else list(SERVE_CASES)))
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    results, again = run_on_mesh(tuple(cases), repeat=cases[0])
    wall = time.perf_counter() - t0
    rows, bad = [], 0
    for case, res in zip(cases, results):
        diff = differences(res["outputs"], run_single(case))
        diff["within"]["planned"] = res["planned"] == res["measured"]
        good = all(diff["within"].values())
        bad += not good
        mesh = "x".join(map(str, POD_MESH_SHAPE if case in POD_CASES
                            else MESH_SHAPE))
        rows.append({"case": ":".join(case), "mesh": mesh,
                     "seconds": res["seconds"],
                     "collectives": res["collectives"],
                     "measured": res["measured"], "planned": res["planned"],
                     **{k: v for k, v in diff.items() if k != "within"},
                     "ok": good})
        print(f"{':'.join(case)}: {res['seconds']:.2f} s on the "
              f"{mesh} mesh, collectives "
              f"{res['collectives']}, measured {res['measured']}, planned "
              f"{'the same' if diff['within']['planned'] else res['planned']}"
              f", against one process "
              f"{ {k: v for k, v in diff.items() if k != 'within'} } "
              f"{'ok' if good else 'DISAGREES ' + str(diff['within'])}",
              flush=True)
    same = bit_identical(results[0], again)
    bad += not same
    print(f"{':'.join(cases[0])} again: "
          f"{'bit-identical' if same else 'DIFFERENT BITS'}; the call "
          f"took {wall:.1f} s", flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps({"rows": rows, "repeat_bit_identical": same,
                                "wall_s": wall}) + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
