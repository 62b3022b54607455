"""peak_mem_gib (GiB, lower): ``torch.cuda.max_memory_allocated`` over
the window, after ``reset_peak_memory_stats`` at its start: whether C
clusters of the model fit on one card."""


def read(run):
    if not run.peak_bytes or run.device_trace is not None:
        return None
    return run.peak_bytes / 2 ** 30
