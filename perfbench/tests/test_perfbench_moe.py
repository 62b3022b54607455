"""The DeepSeek-MoE cell's pieces on the CPU: the reference's layout is
the program's, the grouped products' counts by hand, the roofline
reader, and a small run of the cell (its configuration cut to a CPU
size) correct, each fault the comparison can see at C = 2 caught, and
the control above the sound run."""

import dataclasses
import json
import time
from pathlib import Path

import pytest

from perfbench.harness import cell as cell_mod
from perfbench.harness import counts, counts_moe, faults, spec, trace
from perfbench.harness.weights import check_layout
from perfbench.reference import moe as ref

ROOT = Path(__file__).resolve().parents[2]
CELL = "deepseek-moe-16b.round-1x4096"
SMALL = dict(n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
             d_ff=96, vocab_size=128, n_experts=4, router_experts=16,
             moe_d_ff=32)


def _model(arch):
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.model_api import Model
    fields = ArchConfig.__dataclass_fields__
    return Model(ArchConfig(**{k: v for k, v in arch.items() if k in fields}),
                 device="cpu")


def test_the_cells_layout_is_the_programs():
    """At the cell's own widths: 1 dense layer, 11 MoE layers of 8 held
    experts under a 64-wide router, 1.27 B parameters."""
    arch = spec.load_cell(CELL, ROOT).config["arch"]
    model = _model(arch)
    check_layout(arch, model.param_shapes())
    lay = ref.layout(arch)
    assert lay["layers/moe/router"][0] == (11, 2048, 64)
    assert lay["layers/moe/w_down"][0] == (11, 8, 1408, 2048)
    assert lay["dense_layers/mlp/w_gate"][0] == (1, 2048, 10944)
    assert abs(model.n_params() - 1.274e9) < 1e7


def test_the_config_file_states_the_cut():
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / "deepseek-moe-16b.json").read_text())
    assert set(cfg["reduced"]) == set(cfg["cuts"]) == {
        "n_experts", "vocab_size", "n_layers"}
    pub, arch = cfg["published"], cfg["arch"]
    assert (arch["router_experts"], arch["experts_per_token"],
            arch["moe_d_ff"], arch["d_ff"]) == (
        pub["n_routed_experts"], pub["num_experts_per_tok"],
        pub["moe_intermediate_size"], pub["intermediate_size"])
    assert arch["vocab_size"] * 8 == pub["vocab_size"]


def test_grouped_counts_by_hand():
    """Two launches of 10 rows in all, d 4, f 3, 2 experts: 2·10·4·3
    operations; 10 rows of 4 + 3 elements and 2 · 2 matrices of 4 · 3,
    in bfloat16."""
    assert counts_moe.grouped_flops(10, 4, 3) == 240
    assert counts_moe.grouped_bytes(2, 10, 4, 3, 2) == 2 * (70 + 48)
    # the cell's sizes: compute-bound at 6144 rows a launch
    d, f = 2048, 1408
    s = counts_moe.grouped_bound_s(11, 11 * 6144, d, f, 8)
    assert s == pytest.approx(11 * 2 * 6144 * d * f / counts.PEAK_BF16)


def test_forward_flops_by_hand():
    a = dict(SMALL, family="moe", n_layers=3, first_dense_layers=1,
             experts_per_token=6, n_shared_experts=2)
    D, q, F, R, Fe, V = 64, 64, 96, 16, 32, 128
    per_attn = 2 * 4 * D * q
    pairs = 5 * 6 // 2
    want = (3 * (5 * per_attn + 4 * 32 * 2 * pairs) + 5 * 2 * 3 * D * F
            + 2 * (5 * (2 * D * R + 2 * 3 * D * 2 * Fe)
                   + 5 * 6 * 4 / 16 * 2 * 3 * D * Fe)
            + 5 * 2 * D * V)
    assert ref.forward_flops(a, 1, 5) == pytest.approx(want)


def _run(launches, names):
    tr = trace.DeviceTrace([], (0.0, 1.0), {n: 1e-5 * c for n, c in
                                            names.items()}, names)
    arch = {"d_model": 2048, "moe_d_ff": 1408, "n_experts": 8}
    return cell_mod.Run(arch, {}, "cpu", device_trace=tr, launches=launches)


@pytest.mark.parametrize("lost", [0, 1], ids=["complete", "a-record-lost"])
def test_roofline_reads_only_a_trace_with_every_launch(lost):
    reader = spec.load_reader("moe_grouped_roofline", ROOT)
    names = {"void at::cuda::detail::prepare_grouped_gemm_data<x>(y)": 4,
             "_ZN7cutlass13device_kernelI...GroupProblemShape...E": 4 - lost,
             "other_kernel": 3}
    run = _run({"moe_grouped": 4, "moe_grouped_rows": 4 * 6144}, names)
    least = counts_moe.grouped_bound_s(4, 4 * 6144, 2048, 1408, 8)
    if lost:
        assert reader.read(run) is None
    else:
        assert reader.read(run) == pytest.approx(least / 8e-5 * 100.0)


def test_roofline_is_silent_without_the_counters():
    """A program without the grouped products (the parent of this cell)
    gives no reading, and no error."""
    reader = spec.load_reader("moe_grouped_roofline", ROOT)
    assert reader.read(_run({"flash_attention": 3}, {"k": 1})) is None


def _small(pool: int = 4):
    cell = spec.load_cell(CELL, ROOT)
    arch = dict(cell.config["arch"], **SMALL)
    traffic = dict(cell.traffic, seq_len=24, pool=pool)
    return dataclasses.replace(cell, traffic=traffic), arch


def _run_small(limits=None):
    cell, arch = _small()
    if limits is not None:
        cell = dataclasses.replace(cell, limits=limits)
    t0 = time.perf_counter()
    return cell_mod.run_cell(cell, 2 ** 31 + 11, 0.2, False, "cpu",
                             lambda: time.perf_counter() - t0, arch=arch)


EXACT = ("chain_faults", "stalled_leaves")


@pytest.fixture(scope="module")
def sound():
    """Limits three times a sound small run's readings of the numbers the
    cell compares (the counts at 0)."""
    _, numbers, correct = _run_small()
    cell, _ = _small()
    assert correct
    return {k: (0 if k in EXACT else max(3 * numbers[k]["value"], 1e-9))
            for k in cell.limits}


# wrong_row gives each cluster the other's Eq. 2 partials: with C = 2
# the two replicas lie mirrored about their mean, their similarities
# agree to ~1e-6, and the swap moves nothing the comparison reads
SEEN = sorted(set(faults.FAULTS) - {"wrong_row"})


@pytest.mark.parametrize("fault", SEEN)
def test_each_fault_comes_out_not_correct(sound, fault):
    with faults.FAULTS[fault]():
        _, numbers, correct = _run_small(sound)
    assert not correct, (fault, numbers)


def test_the_control_reads_above_the_sound_run(sound):
    cell, arch = _small()
    numbers = cell_mod.control_numbers(cell, 2 ** 31 + 11, "cpu", arch)
    assert any(numbers[k]["value"] > sound[k] for k in numbers
               if k in sound), (numbers, sound)
