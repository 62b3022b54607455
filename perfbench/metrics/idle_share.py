"""idle_share (%; layer: the device): 1 less the union of the device's
intervals over the traced window (``traced_rounds`` rounds under the
profiler). Moves round_ms."""


def read(run):
    tr = run.device_trace
    if tr is None or tr.window_s <= 0 or not tr.intervals:
        return None
    return (1.0 - tr.busy_s() / tr.window_s) * 100.0
