"""The steps on a mesh of several ranks (``repro_torch.launch.mesh_check``):
the PoFEL round, prefill and decode as DTensor steps on a (2, 2)
``("data", "model")`` mesh of four CPU processes (gloo over a
``FileStore``, no network), held against the same steps in one process.

The cases are the reference's seven ``test_mini_sharded_lowering`` ones
(``tests/test_sharding_specs.py``, which fail in the reference here:
jax 0.9 makes Explicit mesh axes; ROADMAP Queue 3 item 4): five archs at
``baseline`` with C = 4 and yi-6b and deepseek-moe-16b at ``zero3`` with
C = 2 over ``data`` and every lever on; zamba2-7b at ``zero3`` too,
whose Mamba2 blocks then take their ``sharded=`` pins; yi-6b at
``zero3_pod``, C = 4 over ``("pod", "data")`` of a (2, 2, 1) mesh of the
same four processes (the production 2 × 16 × 16 mesh's zero3 split);
then prefill and decode for yi-6b and deepseek-moe-16b. One ``run_on_ranks`` call runs
them all, and the first once more. Tolerances are ``tests/test_torch_pofel_trainer.py``'s
(``mesh_check.differences``): losses within 5e-2, weights within rtol
1e-2 / atol 1e-3, similarities within 1e-4, the same leader where the
top two lie more than 2e-4 apart; logits within the weight rule. No JAX:
both sides are the port's (the reference's side of the levers is
``tests/test_torch_mesh_levers.py``).
"""

import itertools

import pytest
import torch

from repro_torch.launch import mesh_check as mc

TRAIN = mc.TRAIN_CASES + (("zamba2-7b", "zero3"),) + mc.POD_CASES
CASES = TRAIN + mc.SERVE_CASES
IDS = [":".join(c) for c in CASES]


@pytest.fixture(scope="module")
def mesh_results():
    """Every case on the four ranks in one call (its own time limit), and
    the first case's second run."""
    results, again = mc.run_on_mesh(CASES, repeat=CASES[0], timeout=300)
    return dict(zip(CASES, results)), again


@pytest.fixture(scope="module")
def single():
    """Each case's step in this process (a world-size-1 gloo group, one
    CPU thread)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield mc.run_single
    if dist.is_initialized():
        dist.destroy_process_group()
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_step_on_four_ranks_matches_one_process(mesh_results, single,
                                                case):
    diff = mc.differences(mesh_results[0][case]["outputs"], single(case))
    assert all(diff["within"].values()), diff
    if case in TRAIN:
        # the similarities spread, so the comparison above means something
        sims = mesh_results[0][case]["outputs"]["sims"]
        assert float(sims.max() - sims.min()) > 10 * mc.SIM_ATOL, sims


def test_a_second_run_is_bit_identical(mesh_results):
    results, again = mesh_results
    assert again is not None
    assert mc.bit_identical(results[CASES[0]], again)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_the_mesh_moves_data(mesh_results, case):
    """Every step issued collectives on the (2, 2) mesh."""
    counts = mesh_results[0][case]["collectives"]
    assert sum(counts.values()) > 0, counts


KIND_OF_OP = {"all_gather_into_tensor": "all-gather",
              "allgather_": "all-gather", "all_reduce": "all-reduce",
              "allreduce_": "all-reduce",
              "reduce_scatter_tensor": "reduce-scatter",
              "all_to_all_single": "all-to-all"}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_planned_collectives_equal_measured(mesh_results, case):
    """The collectives the step plans on its abstract arguments (meta
    tensors, nothing moved: the roofline's count) are those its run on
    the four ranks issued, kind by kind in count and bytes a device and
    axis by axis in bytes; and the counts are ``CommDebugMode``'s."""
    res = mesh_results[0][case]
    assert res["planned"] == res["measured"]
    by_kind = {}
    for op, n in res["collectives"].items():
        kind = KIND_OF_OP[op.split("::")[-1]]
        by_kind[kind] = by_kind.get(kind, 0) + n
    assert res["measured"]["count_by_kind"] == by_kind
    axes = mc.POD_MESH_AXES if case in mc.POD_CASES else mc.MESH_AXES
    joins = {"+".join(c) for n in range(1, len(axes) + 1)
             for c in itertools.combinations(axes, n)}
    assert set(res["measured"]["bytes_by_axis"]) <= joins
