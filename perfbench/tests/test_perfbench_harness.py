"""The harness: cells, configurations and metrics found by name; the
result line's keys; no card, no result; no JAX; and the comparison
that decides ``correct`` catching each fault the cells can have, and
the control, on a small configuration on the CPU (the look for a card
skipped, the rest of a run driven)."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from perfbench.harness import cell as cell_mod
from perfbench.harness import faults, spec, trace
from perfbench.harness.check import NUMBERS

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]

SMALL = {
    "audio": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                  head_dim=32, d_ff=256, vocab_size=256, n_context_tokens=8),
}


def small(name: str, pool: int = 4):
    """The cell with a small configuration and short rows."""
    cell = spec.load_cell(name, ROOT)
    arch = dict(cell.config["arch"], **SMALL[cell.config["arch"]["family"]])
    traffic = dict(cell.traffic, seq_len=24, pool=pool,
                   seqs_per_cluster=min(2, cell.traffic["seqs_per_cluster"]))
    return dataclasses.replace(cell, traffic=traffic), arch


def run_small(name: str, seed: int = 2 ** 31 + 11, traced: bool = False,
              limits=None):
    cell, arch = small(name)
    if limits is not None:
        cell = dataclasses.replace(cell, limits=limits)
    t0 = time.perf_counter()
    return cell, cell_mod.run_cell(cell, seed, 0.2, traced, "cpu",
                                   lambda: time.perf_counter() - t0,
                                   arch=arch)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    cell = spec.load_cell(name, ROOT)
    work = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.chips == work["chips"]
    assert cell.config["name"] == work["config"]
    assert set(cell.limits) <= set(NUMBERS)
    assert {m.name for m in cell.end_to_end} >= {"setup_s"}
    listed = {m["name"] for m in BENCH["per_layer"]
              if name in m.get("workloads", [name])}
    assert {m.name for m in cell.per_layer} == listed
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.reader.read)


def test_every_metric_and_config_has_its_file():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
    for c in BENCH["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]


@pytest.mark.parametrize("lost", ["nothing", "lead", "tail"])
def test_trace_reduction_sets_the_clock_by_the_last_leading_marker(lost):
    """Kernel records in µs on the device's clock: the clock's marker at
    host time 10 s, two kernels, then the tail's markers. Records the
    profiler loses at either end leave the clock set and the kernels in
    place; a trace whose tail is lost is not complete."""
    m = trace.MARKER
    lead = [(100.0, 101.0, m), (200.0, 201.0, m)]
    kernels = [(300.0, 400.0, "k1"), (500.0, 600.0, "k2")]
    tail = [(700.0, 701.0, m)]
    spans = {"nothing": lead + kernels + tail, "lead": lead[1:] + kernels
             + tail, "tail": lead + kernels}[lost]
    tr = trace.reduce(spans[::-1], 10.0, 10.0005)
    assert tr.intervals == [(pytest.approx(10.0001), pytest.approx(10.0002),
                             "k1"), (pytest.approx(10.0003),
                                     pytest.approx(10.0004), "k2")]
    assert tr.complete == (lost != "tail")
    assert tr.busy_s() == pytest.approx(2e-4)
    assert sum(b - a for a, b in tr.gaps()) == pytest.approx(3e-4)


@pytest.mark.parametrize("lost", [0, 1], ids=["complete", "a-record-lost"])
def test_me_roofline_reads_only_a_trace_with_every_launch(lost):
    """The ME share is the launches' least time over the kernels' traced
    time; a trace that lost a record gives no reading (a share read from
    it would be too high)."""
    from perfbench.harness import counts
    reader = spec.load_reader("me_roofline", ROOT)
    leaves = [(4, 1000, 2), (4, 10, 4)]
    names = {"weighted_agg<bf16>": 4 - lost, "cosine_partials<bf16>": 4}
    tr = trace.DeviceTrace([], (0.0, 1.0), {n: 1e-6 * c for n, c in
                                            names.items()}, names)
    run = cell_mod.Run({}, {}, "cpu", device_trace=tr, traced_rounds=2,
                       leaves=leaves, launches={"weighted_aggregate": 4,
                                                "cosine_partials": 4})
    least = 2 * sum(counts.weighted_agg_bound_s(*x)
                    + counts.cosine_partials_bound_s(*x) for x in leaves)
    if lost:
        assert reader.read(run) is None
    else:
        assert reader.read(run) == pytest.approx(least / 8e-6 * 100.0)


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_result_line_keys(traced):
    from perfbench import run as run_py
    cell, (run, numbers, correct) = run_small(CELLS[0], traced=traced)
    if traced:   # the CPU has no device trace: stand one in
        run.device_trace = trace.DeviceTrace(
            [(0.0, 0.5, "k1"), (0.6, 1.0, "k2")], (0.0, 1.0),
            {"k1": 0.5, "k2": 0.4})
    line = run_py.result_line(cell, run, numbers, correct, traced,
                              "cpu-test", "n/a")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if traced else []
    assert list(line) == keys + ["checks"]
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])
    if traced:
        assert line["device"]["busy_s"] == pytest.approx(0.9)
        assert line["metrics"]["idle_share"]["value"] == pytest.approx(10.0)
    else:
        assert set(line["metrics"]) == {"round_ms", "setup_s"}
    json.dumps(line)


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "repro"}
    for path in (ROOT / "perfbench").rglob("*.py"):
        assert not (_imports(path) & bad), path
    for path in (ROOT / "perfbench" / "reference").rglob("*.py"):
        assert not (_imports(path) & {"repro_torch", "importlib"}), path


def test_loading_the_harness_and_the_program_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import perfbench.run as r;"
            "from perfbench.harness import cell, program;"
            "program.import_program();"
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


EXACT = ("chain_faults", "stalled_leaves")


@pytest.fixture(scope="module", params=CELLS)
def sound(request):
    """A cell and limits three times a sound small run's readings of the
    numbers the cell compares (the counts at 0): what each fault has to
    break at this size."""
    name = request.param
    cell, (_, numbers, _) = run_small(name)
    assert numbers["chain_faults"]["value"] == 0
    return name, {k: (0 if k in EXACT else max(3 * numbers[k]["value"],
                                               1e-9)) for k in cell.limits}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_each_fault_comes_out_not_correct(sound, fault):
    name, limits = sound
    with faults.FAULTS[fault]():
        _, (_, numbers, correct) = run_small(name, limits=limits)
    assert not correct, (fault, numbers)


def test_the_control_reads_well_above_the_program(sound):
    """The reference with float8 products in the program's place fails
    at least one of the cell's numbers by three times the sound run's
    reading."""
    name, limits = sound
    cell, arch = small(name)
    numbers = cell_mod.control_numbers(cell, 2 ** 31 + 11, "cpu", arch)
    assert any(numbers[k]["value"] > limits[k] for k in numbers
               if k in limits), (numbers, limits)
