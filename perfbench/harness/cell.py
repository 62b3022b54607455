"""One run of a cell: set-up, the measured window, the comparison.

Set-up makes the pool of batches, the weights and the clusters' starting
replicas (apart, so that Eq. 2 and the vote have something to tell; the
later rounds start from the redistributed global model) from the seed,
builds the program's trainer once, and drives it through the traffic's
``check_rounds`` rounds with the window's own call (these warm every
shape the window uses and give the comparison its readings). The window
then runs rounds, cycling through the pool, until ``seconds`` have
passed, and takes its metrics: untraced, the end-to-end ones; traced
(``trace``), the per-layer ones from host spans around the program's
calls (each with a synchronize on both sides) and from the device's
trace of ``traced_rounds`` further rounds. After the window the
program's state is freed and the plain reference follows the checked
rounds.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench.harness import counts, trace
from perfbench.harness.check import (ProgramReadings, RoundRecord, compare,
                                     judge)
from perfbench.harness.program import (ForwardMemory, Program, keypair_seed,
                                       wrapped)
from perfbench.harness.spec import Cell
from perfbench.harness.traffic import cluster_slices, token_pool
from perfbench.harness.weights import (diverged, flatten, make_weights,
                                       mean_replica, model_reference)
from perfbench.reference import chain as ref_chain
from perfbench.reference import pofel as ref_pofel
from perfbench.reference.precision import Products


@dataclass
class Run:
    """What a run measured; the metric readers read it."""
    arch: dict
    traffic: dict
    device: torch.device
    setup_s: float = 0.0
    rounds: int = 0
    window_s: float = 0.0
    peak_bytes: int = 0
    failed: int = 0
    # traced
    span_totals: Dict[str, float] = field(default_factory=dict)
    span_counts: Dict[str, int] = field(default_factory=dict)
    backward_alloc_bytes: Optional[int] = None
    device_trace: Optional[trace.DeviceTrace] = None
    traced_rounds: int = 0
    launches: Dict[str, int] = field(default_factory=dict)
    flash_shapes: Dict[tuple, int] = field(default_factory=dict)
    flash_backward_shapes: Dict[tuple, int] = field(default_factory=dict)
    leaves: List[tuple] = field(default_factory=list)   # (C, n, itemsize)
    idle_gaps: List[list] = field(default_factory=list)
    round_ends: List[float] = field(default_factory=list)   # window, s

    def round_model_flops(self) -> float:
        return counts.round_model_flops(self.arch, self.traffic)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _record(m, history_before=None, history_after=None) -> RoundRecord:
    return RoundRecord(m.loss.numpy().copy(), m.similarities.numpy().copy(),
                       int(m.leader), m.vote_weights.numpy().copy(),
                       m.scores.numpy().copy(), history_before,
                       history_after)


def _keep(m, readings: ProgramReadings, run: Run) -> None:
    """A window round's metrics, kept for the chain's check; a round
    whose losses are not finite counts as failed."""
    readings.rounds.append(_record(m))
    if not bool(np.all(np.isfinite(readings.rounds[-1].losses))):
        run.failed += 1


def _norms(a: dict, tree: dict) -> Dict[str, float]:
    """‖a − w‖ a leaf, for the flat ``a`` and the nested ``tree``."""
    return ref_pofel.leaf_change_norms(a, flatten(tree))


def starting_point(cell: Cell, seed: int, device, arch: dict) -> tuple:
    """(the global weights, the clusters' starting replicas, their mean):
    what both sides start from, made from the seed."""
    weights = make_weights(arch, seed, device)
    start = diverged(weights, seed, cell.traffic["clusters"],
                     cell.traffic["replica_spread"])
    return weights, start, mean_replica(start)


def set_up(cell: Cell, seed: int, device, arch: dict) -> tuple:
    """(the program after its checked rounds, the pool, the program's
    readings)."""
    traffic = cell.traffic
    t0 = time.perf_counter()
    pool = token_pool(seed, traffic, arch, device)
    weights, start, a0 = starting_point(cell, seed, device, arch)
    prog = Program(arch, traffic, weights, seed, device, start)
    del weights, start
    trace.sync(device)
    say(f"set-up: pool, weights, replicas and trainer in "
        f"{time.perf_counter() - t0:.2f} s")
    readings = ProgramReadings()
    R, R_ref = traffic["check_rounds"], traffic["reference_rounds"]
    for k in range(R):
        t0 = time.perf_counter()
        before = prog.history().numpy().copy()
        m = prog.round(pool[k % len(pool)])
        readings.rounds.append(_record(m, before, prog.history().numpy()))
        say(f"set-up: checked round {k} in {time.perf_counter() - t0:.2f} s")
        if k == 0:
            readings.first_step = _norms(a0, prog.global_params())
        if k + 1 == R_ref:
            readings.change = _norms(a0, prog.global_params())
    del a0
    return prog, pool, readings


def window(prog: Program, pool: list, seconds: float, first: int,
           readings: ProgramReadings, run: Run) -> int:
    """Rounds until ``seconds`` have passed; each round's metrics are
    recorded for the chain's check. Returns the rounds run."""
    n = 0
    t0 = time.perf_counter()
    while True:
        m = prog.round(pool[(first + n) % len(pool)])
        run.round_ends.append(time.perf_counter() - t0)
        _keep(m, readings, run)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    trace.sync(prog.device)
    run.window_s = time.perf_counter() - t0
    return n


def traced_window(prog: Program, pool: list, seconds: float, first: int,
                  readings: ProgramReadings, run: Run) -> int:
    """The window with host spans (synchronized) around the program's
    calls, then ``traced_rounds`` rounds under the profiler."""
    dev = prog.device
    spans = trace.Spans(dev, sync_each=True)
    fwd = ForwardMemory(prog)
    back = 0
    n = 0
    t0 = time.perf_counter()
    with wrapped(prog, spans), fwd:
        while True:
            _reset_peak(dev)
            fwd.end = 0
            with spans("round"):
                m = prog.round(pool[(first + n) % len(pool)], spans)
            _keep(m, readings, run)
            back = max(back, _peak(dev) - fwd.end)
            run.peak_bytes = max(run.peak_bytes, _peak(dev))
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
    run.window_s = time.perf_counter() - t0
    run.span_totals = spans.totals()
    run.span_counts = {k: spans.count(k) for k in run.span_totals}
    run.backward_alloc_bytes = back if dev.type == "cuda" else None
    if dev.type != "cuda":
        return n
    ops = prog.m["ops"]
    host = trace.Spans(dev, sync_each=False)
    k = run.traffic["traced_rounds"]

    def traced():
        nonlocal n
        with wrapped(prog, host):
            for _ in range(k):
                m = prog.round(pool[(first + n) % len(pool)], host)
                _keep(m, readings, run)
                n += 1

    for _ in range(3):   # a trace that lost records is taken again
        host.events.clear()
        ops.reset_launch_counts()
        _, run.device_trace = trace.profile(traced, dev)
        if run.device_trace.complete:
            break
        say("the device trace lost its last records; tracing again")
    run.traced_rounds = k
    run.launches = ops.launch_counts()
    run.flash_shapes = ops.flash_launch_shapes()
    run.flash_backward_shapes = ops.flash_backward_launch_shapes()
    run.idle_gaps = trace.idle_by_span(run.device_trace, host)
    return n


def reference_rounds(cell: Cell, seed: int, device, arch: dict,
                     pool: list, precision: str = "float32") -> tuple:
    """The reference's rounds from the seed's starting replicas and the
    checked rounds' batches: (their RoundOuts, ‖a0 − w1‖ and ‖a0 − w_R‖
    by leaf, a0 the replicas' mean)."""
    traffic = cell.traffic
    prod = Products(precision)
    C, R = traffic["clusters"], traffic["reference_rounds"]
    _, start, a0 = starting_point(cell, seed, device, arch)
    w = None
    outs = []
    first = None
    for k in range(R):
        batches = [{key: torch.as_tensor(v).to(device)
                    for key, v in b.items()}
                   for b in cluster_slices(pool[k % len(pool)], C)]
        w, out = ref_pofel.fedsgd_round(
            w, batches, model_reference(arch).loss_and_grads, arch,
            traffic["inner_lr"], prod, start)
        start = None
        outs.append(out)
        if k == 0:
            first = _norms(a0, w)
    change = _norms(a0, w)
    del w, a0
    free(torch.device(device))
    return outs, first, change


def reference_numbers(cell: Cell, seed: int, device, arch: dict,
                      pool: list, readings: ProgramReadings
                      ) -> Dict[str, dict]:
    """The numbers compared: the program's readings against the plain
    reference's rounds."""
    outs, first, change = reference_rounds(cell, seed, device, arch, pool)
    pk = ref_chain.public_key(keypair_seed(seed))
    return compare(readings, outs, first, change, cell.traffic["pofel"], pk)


def control_numbers(cell: Cell, seed: int, device, arch: dict
                    ) -> Dict[str, dict]:
    """The control: the reference computed with float8 products in the
    program's place, against the float32 reference. The numbers the
    program has no counterpart for here (the tally, the chain) are left
    out."""
    pool = token_pool(seed, cell.traffic, arch, device)
    outs, first, change = reference_rounds(cell, seed, device, arch, pool,
                                           "fp8")
    readings = ProgramReadings(
        rounds=[RoundRecord(o.losses, o.sims.astype(np.float32),
                            int(np.argmax(o.sims)), np.zeros(0),
                            np.zeros(0)) for o in outs],
        first_step=first, change=change)
    ref = reference_rounds(cell, seed, device, arch, pool)
    return compare(readings, *ref, cell.traffic["pofel"], None, chain=False)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             started: Callable[[], float],
             arch: Optional[dict] = None) -> tuple:
    """One run: (Run, the numbers compared, correct). ``started()`` gives
    the seconds since the process started; ``arch`` replaces the
    configuration's (tests run a small one on the CPU)."""
    device = torch.device(device)
    arch = arch or cell.config["arch"]
    run = Run(arch, cell.traffic, device)
    if traced and device.type == "cuda":
        trace.warm_profiler(device)
    say(f"set-up begins at {started():.2f} s since the process started")
    prog, pool, readings = set_up(cell, seed, device, arch)
    trace.sync(device)
    say(f"set-up done at {started():.2f} s since the process started")
    first = cell.traffic["check_rounds"]
    _reset_peak(device)
    run.setup_s = started()
    if traced:
        run.rounds = traced_window(prog, pool, seconds, first, readings,
                                   run)
    else:
        run.rounds = window(prog, pool, seconds, first, readings, run)
        run.peak_bytes = _peak(device)
    run.leaves = [(cell.traffic["clusters"], t.numel(), t.element_size())
                  for t in flatten(prog.global_params()).values()]
    readings.blocks = [asdict(b) for b in prog.blocks()]
    readings.chain_verifies = prog.chain_verifies()
    del prog
    free(device)
    gaps = np.diff([0.0] + run.round_ends) * 1e3
    say(f"window: {run.rounds} rounds in {run.window_s:.3f} s" + (
        f"; rounds {gaps.min():.1f}-{np.median(gaps):.1f}-{gaps.max():.1f}"
        f" ms (min-median-max)" if len(gaps) else ""))
    t_ref = time.perf_counter()
    numbers = reference_numbers(cell, seed, device, arch, pool, readings)
    say(f"reference: {time.perf_counter() - t_ref:.2f} s")
    run.failed = min(run.rounds,
                     run.failed + numbers["chain_faults"]["value"])
    correct = judge(numbers, cell.limits)
    return run, numbers, correct


def metric_values(metrics, run: Run) -> Dict[str, dict]:
    """Each metric whose reader finds something to read."""
    out = {}
    for m in metrics:
        value = m.reader.read(run)
        if value is not None and math.isfinite(value):
            out[m.name] = {"value": value, "unit": m.unit}
    return out
