"""moe_grouped_roofline (%; layer: kernels, kernels.moe_grouped): the
least time of the traced rounds' grouped expert products (their launches
and rows from ``ops.launch_counts()``'s ``moe_grouped`` and
``moe_grouped_rows``, at the configuration's d_model and moe_d_ff;
harness.counts_moe) over the device time of the grouped products'
kernels in the trace (each launch two: ``prepare_grouped_gemm_data``,
which writes the groups' pointers and sizes on the device, then the
grouped GEMM, a CUTLASS ``GroupProblemShape`` kernel). Read only where
the trace holds a record of every launch. Moves round_ms."""

from perfbench.harness import counts_moe

KERNELS = ("prepare_grouped_gemm_data", "GroupProblemShape")
PER_LAUNCH = len(KERNELS)


def _ours(name: str) -> bool:
    return any(k in name for k in KERNELS)


def read(run):
    tr = run.device_trace
    launches = run.launches.get("moe_grouped")
    rows = run.launches.get("moe_grouped_rows")
    if tr is None or not launches or not rows:
        return None
    if sum(c for n, c in tr.count_by_name.items() if _ours(n)) \
            != PER_LAUNCH * launches:
        return None
    a = run.arch
    least = counts_moe.grouped_bound_s(launches, rows, a["d_model"],
                                       a["moe_d_ff"], a["n_experts"])
    spent = sum(t for n, t in tr.by_name.items() if _ours(n))
    return least / spent * 100.0 if spent > 0 else None
