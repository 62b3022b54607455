"""flash_roofline (%; layer: kernels, kernels.flash_attention forward and
backward): the least time of the traced rounds' flash launches (their
shapes from ``ops.flash_launch_shapes`` and
``flash_backward_launch_shapes``; harness.counts) over the device time
of the flash kernels in the trace (a forward launch is one kernel, a
backward launch two: dQ, then dK and dV). Read only where the trace
holds a record of every launch. Moves round_ms."""

from perfbench.harness import counts

KERNELS = ("flash_fwd_tc", "flash_fwd_f32", "flash_bwd_dq_wg",
           "flash_bwd_dkdv_wg", "flash_bwd_dq_f32", "flash_bwd_dkdv_f32")


def read(run):
    tr = run.device_trace
    if tr is None or not (run.flash_shapes or run.flash_backward_shapes):
        return None
    if tr.kernel_count(KERNELS) != sum(run.flash_shapes.values()) \
            + 2 * sum(run.flash_backward_shapes.values()):
        return None
    least = 0.0
    for shapes, bound in ((run.flash_shapes, counts.flash_fwd_bound_s),
                          (run.flash_backward_shapes,
                           counts.flash_bwd_bound_s)):
        for (B, Sq, Skv, Hq, Hk, hd, dtype, causal, window), n in \
                shapes.items():
            least += n * bound(B, Sq, Skv, Hq, Hk, hd, dtype, causal,
                               window)
    spent = tr.kernel_seconds(KERNELS)
    return least / spent * 100.0 if spent > 0 else None
