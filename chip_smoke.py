#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

needs one NVIDIA Hopper card (H100), the CUDA toolkit (``nvcc``) and a
CUDA build of PyTorch. It never imports JAX or the reference package
``repro``. Phases, each of which fails the script:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compiles ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a (one
   ``nvcc`` per source, in parallel) into ``build/repro_torch_kernels/``;
3. kernels: each ME kernel at (N, D) = (8, 101770) and (50, 101770), in
   float32 and bfloat16, against its plain PyTorch version on the card,
   twice on the same input (the outputs must be bit-identical), then
   timed with CUDA events over CUDA-graph replays (device time per call,
   median of 50) beside its plain version, a PyTorch library call and
   the card's byte bound;
4. main path: ``repro_torch.api.run_bhfl(model="mlp", n_nodes=8,
   clients_per_node=5, fel_iterations=3, rounds=3, seed=0,
   device="cuda")`` at the §7.1 width 784-128-10; the chain must verify
   at height 3, every loss be finite, and each kernel wrapper have
   launched exactly once per round;
5. profile: one more round of the main path's runtime under
   ``torch.profiler``: the device's busy time (the union of its kernel
   and copy intervals), set against the median wall time of the
   unprofiled rounds, and the kernels that took it;
6. agreement: with dropout off, a short run on the card must elect the
   same leaders as the same run on the CPU (plain versions), with
   similarities and accuracy within tolerance.

It prints a JSON line of kernel results, the ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``. It exits non-zero, before that
line, when there is no CUDA device or any check fails.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM3 bandwidth and fp32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SHAPES = ((8, 101_770), (50, 101_770))
MAIN_ROUNDS = 3


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def graph_time_us(fn, reps: int = 20, samples: int = 50) -> float:
    """Median device time of one ``fn()`` call: ``reps`` calls captured in
    a CUDA graph, each replay timed with CUDA events, so host-side
    dispatch is not in the figure."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(samples):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / reps)
    return statistics.median(times)


def call_time_us(fn, samples: int = 50) -> float:
    """Median time of one eager call as the device timeline sees it
    (includes any wait for the host to issue the launches)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(samples):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def bound_us(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e6,
            "bytes" if t_bytes >= t_ops else "operations")


def entry(name, source, replaces, W, max_err, bit, k_us, p_us, b, lib_us,
          call_us, **extra):
    b_us, b_by = b
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None,
            "shape": list(W.shape), "dtype": str(W.dtype).split(".")[-1],
            "max_abs_err": max_err, "bit_identical": bit,
            "ms": k_us / 1e3, "plain_ms": p_us / 1e3,
            "bound_ms": b_us / 1e3, "bound_by": b_by,
            "library_ms": lib_us / 1e3,
            "kernel_us": k_us, "plain_us": p_us, "bound_us": b_us,
            "library_us": lib_us, "call_us": call_us, **extra}


def check_partials(W, gw) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import cosine_partials_ref
    out = ops.cosine_partials(W, gw)
    again = ops.cosine_partials(W, gw)
    torch.cuda.synchronize()
    ref = cosine_partials_ref(W, gw)
    bit = all(torch.equal(a, b) for a, b in zip(out, again))
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    tag = f"cosine_partials {tuple(W.shape)} {W.dtype}"
    check(bit, f"{tag}: two launches on one input differ")
    # tests/test_kernels.py:36-39 (dot atol 1e-2; all rtol 1e-4)
    check(torch.allclose(out[0], ref[0], rtol=1e-4, atol=1e-2)
          and torch.allclose(out[1], ref[1], rtol=1e-4, atol=0)
          and torch.allclose(out[2], ref[2], rtol=1e-4, atol=0),
          f"{tag}: disagrees with cosine_partials_ref (max abs err {err})")
    N, D = W.shape
    n_bytes = N * D * W.element_size() + D * gw.element_size() \
        + (2 * N + 1) * 4
    return entry(
        "cosine_partials", "src/repro_torch/kernels/csrc/cosine_partials.cu",
        "src/repro/kernels/cosine_sim.py:27", W, err, bit,
        graph_time_us(lambda: ops.cosine_partials(W, gw)),
        graph_time_us(lambda: cosine_partials_ref(W, gw)),
        bound_us(n_bytes, 4.0 * N * D + 2.0 * D),
        graph_time_us(lambda: F.cosine_similarity(W, gw[None], dim=1)),
        call_time_us(lambda: ops.cosine_partials(W, gw)),
        kernel_combine_us=graph_time_us(
            lambda: ops.batched_cosine_similarity(W, gw)),
        library_call="torch.nn.functional.cosine_similarity, against "
                     "kernel_combine_us (kernel + combine)")


def check_aggregate(W, w) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import weighted_aggregate_ref
    out = ops.weighted_aggregate(W, w)
    again = ops.weighted_aggregate(W, w)
    torch.cuda.synchronize()
    ref = weighted_aggregate_ref(W, w)
    bit = torch.equal(out, again)
    err = float((out - ref).abs().max())
    tag = f"weighted_aggregate {tuple(W.shape)} {W.dtype}"
    check(bit, f"{tag}: two launches on one input differ")
    # tests/test_kernels.py:19-21,86
    tol = (dict(rtol=2e-2, atol=2e-2) if W.dtype == torch.bfloat16
           else dict(rtol=2e-5, atol=2e-6))
    check(torch.allclose(out, ref, **tol),
          f"{tag}: disagrees with weighted_aggregate_ref (max abs err {err})")
    N, D = W.shape
    lam = (w / w.sum()).to(W.dtype)
    Wt = W.t()
    return entry(
        "weighted_aggregate", "src/repro_torch/kernels/csrc/weighted_agg.cu",
        "src/repro/kernels/weighted_agg.py:21", W, err, bit,
        graph_time_us(lambda: ops.weighted_aggregate(W, w)),
        graph_time_us(lambda: weighted_aggregate_ref(W, w)),
        bound_us(N * D * W.element_size() + N * 4 + D * 4, 2.0 * N * D),
        graph_time_us(lambda: torch.mv(Wt, lam)),
        call_time_us(lambda: ops.weighted_aggregate(W, w)),
        library_call="torch.mv(W.t(), lam)")


def phase_kernels(dev) -> list:
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for N, D in SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            W = torch.randn(N, D, generator=gen, device=dev).to(dt)
            gw = torch.randn(D, generator=gen, device=dev).to(dt)
            w = torch.rand(N, generator=gen, device=dev) * 99.0 + 1.0
            for row in (check_partials(W, gw), check_aggregate(W, w)):
                print(f"kernel {row['name']} {row['shape']} {row['dtype']}: "
                      f"max_abs_err {row['max_abs_err']:.3e} bit-identical "
                      f"{row['bit_identical']} | kernel {row['kernel_us']:.2f}"
                      f" us, plain {row['plain_us']:.2f} us, library "
                      f"{row['library_us']:.2f} us, bound "
                      f"{row['bound_us']:.2f} us, eager call "
                      f"{row['call_us']:.2f} us", flush=True)
                rows.append(row)
    return rows


def time_model_evaluation(dev, N: int = 8, D: int = 101_770) -> float:
    """Wall time of one synchronized ME call (flattened models already
    stacked) at the main path's shape, median of 20, in ms."""
    import torch
    from repro_torch.core.model_eval import model_evaluation
    gen = torch.Generator(device=dev).manual_seed(1)
    W = torch.randn(N, D, generator=gen, device=dev)
    sizes = torch.full((N,), 500.0, device=dev)
    times = []
    for _ in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = model_evaluation(W, sizes)
        res.similarities.cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[5:])


def phase_main_path(dev):
    import torch
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.obs import TraceRecorder, use_recorder
    rec = TraceRecorder("chip_smoke")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with use_recorder(rec):
        run = api.run_bhfl(model="mlp", n_nodes=8, clients_per_node=5,
                           fel_iterations=3, rounds=MAIN_ROUNDS, seed=0,
                           device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(run.chain_valid, "main path: chain does not verify")
    check(run.chain_height == MAIN_ROUNDS,
          f"main path: chain height {run.chain_height} != {MAIN_ROUNDS}")
    check(all(math.isfinite(m.test_loss) and math.isfinite(m.test_accuracy)
              for m in run.history), "main path: non-finite loss/accuracy")
    for name, n in counts.items():
        check(n == MAIN_ROUNDS,
              f"main path: {name} launched {n} times in {MAIN_ROUNDS} "
              f"rounds (want one per round)")
    w1 = run.runtime.global_params["w1"]
    check(w1.is_cuda and tuple(w1.shape) == (784, 128),
          f"main path: global model w1 is {tuple(w1.shape)} on {w1.device}")
    per_round = {}
    for s in rec.spans:
        if s.round is None:
            continue
        d = per_round.setdefault(s.round, {})
        d[s.name] = d.get(s.name, 0.0) + s.wall_dur * 1e3
    for k in sorted(per_round):
        m = run.history[k]
        print(f"round {k}: wall {per_round[k]['round']:.1f} ms, fel "
              f"{per_round[k]['fel']:.1f} ms, ME phase "
              f"{per_round[k]['phase:model_evaluation']:.2f} ms (host), "
              f"leader {m.leader_id}, acc {m.test_accuracy:.4f}, loss "
              f"{m.test_loss:.4f}", flush=True)
    me_ms = time_model_evaluation(dev)
    print(f"model_evaluation (8, 101770) synchronized: {me_ms:.3f} ms",
          flush=True)
    summary = {"wall_s": wall, "launches": counts,
               "chain_height": run.chain_height,
               "leaders": [m.leader_id for m in run.history],
               "test_accuracy": [m.test_accuracy for m in run.history],
               "test_loss": [m.test_loss for m in run.history],
               "me_sync_ms": me_ms,
               "round_ms": {str(k): v for k, v in per_round.items()}}
    print("main_path " + json.dumps(summary), flush=True)
    round_ms = statistics.median(per_round[k]["round"] for k in per_round)
    return counts, run.runtime, round_ms


def phase_profile(runtime, round_ms: float) -> None:
    """Device busy share of one round: the union of the device's kernel
    and copy intervals in a profiled round, over the median wall time of
    the unprofiled rounds (the profiler slows the host, not the device)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runtime.run_round()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    check(len(spans) > 0, "profile: the profiler saw no device activity")
    busy_us, end = 0.0, float("-inf")
    by_name: dict = {}
    for t0, t1, name in spans:
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    share = busy_us / (round_ms * 1e3)
    print(f"profile: {len(spans)} device ops, busy {busy_us:.0f} us in a "
          f"{round_ms:.1f} ms round: busy share {share:.4f}, idle share "
          f"{1 - share:.4f}", flush=True)
    print("profile " + json.dumps({
        "device_ops": len(spans), "busy_us": busy_us, "round_ms": round_ms,
        "busy_share": share,
        "top_us": [[n[:80], round(t, 1)] for n, t in top]}), flush=True)


def phase_agreement(dev) -> None:
    """The card against the CPU on one short run with dropout off: the
    same leaders, similarities within 1e-4 and accuracy within 1e-3."""
    import numpy as np
    from repro_torch import api
    from repro_torch.models.mlp import MLPConfig
    kw = dict(model="mlp", n_nodes=4, clients_per_node=2, fel_iterations=1,
              rounds=2, seed=3, mlp=MLPConfig(dropout=0.0),
              data=api.make_mnist_like(400, 100, seed=3))
    gpu = api.run_bhfl(device=dev, **kw)
    cpu = api.run_bhfl(device="cpu", **kw)
    check(gpu.chain_valid and cpu.chain_valid, "agreement: invalid chain")
    for g, c in zip(gpu.history, cpu.history):
        sg = np.asarray(g.consensus.similarities, np.float64)
        sc = np.asarray(c.consensus.similarities, np.float64)
        check(np.allclose(sg, sc, rtol=0, atol=1e-4),
              f"agreement: round {g.round} similarities {sg} vs {sc}")
        top = np.sort(sc)[-2:]
        if top[1] - top[0] > 1e-3:   # leader decided by a clear margin
            check(g.leader_id == c.leader_id,
                  f"agreement: round {g.round} leader {g.leader_id} vs "
                  f"{c.leader_id}")
        check(abs(g.test_accuracy - c.test_accuracy) <= 1e-3,
              f"agreement: round {g.round} accuracy {g.test_accuracy} vs "
              f"{c.test_accuracy}")
    print("agreement: card and CPU agree on leaders "
          f"{[m.leader_id for m in gpu.history]}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    # 1. card
    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    # 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s into "
          f"{_build.build_dir()} ({built or 'cached'})", flush=True)
    for name in _build.SOURCES:
        print(f"--- nvcc {name}.cu ---\n{_build.build_log(name).strip()}",
              flush=True)
    # 3. kernels
    rows = phase_kernels(dev)
    # 4. main path
    counts, runtime, round_ms = phase_main_path(dev)
    # 5. where the device time goes
    phase_profile(runtime, round_ms)
    # 6. the card against the CPU
    phase_agreement(dev)
    for row in rows:
        row["launches"] = counts[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
