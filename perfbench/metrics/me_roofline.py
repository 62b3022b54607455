"""me_roofline (%; layer: kernels, kernels.weighted_agg and
kernels.cosine_sim): the least time of the traced rounds' Eq. 1 and
Eq. 2 launches, one each a parameter leaf and round, each reading the
leaf's (C, n) rows (and Eq. 2 also gw) once (byte-bound;
harness.counts), over the device time of the two kernels in the trace.
Read only where the trace holds a record of every launch. Moves
round_ms."""

from perfbench.harness import counts

KERNELS = ("weighted_agg", "cosine_partials")


def read(run):
    tr = run.device_trace
    if tr is None or not run.leaves or not run.traced_rounds:
        return None
    launched = run.traced_rounds * len(run.leaves)
    if not (run.launches.get("weighted_aggregate") == launched
            == run.launches.get("cosine_partials")
            and tr.kernel_count(KERNELS) == 2 * launched):
        return None
    least = run.traced_rounds * sum(
        counts.weighted_agg_bound_s(C, n, size)
        + counts.cosine_partials_bound_s(C, n, size)
        for C, n, size in run.leaves)
    spent = tr.kernel_seconds(KERNELS)
    return least / spent * 100.0 if spent > 0 else None
