"""round_ms (ms, lower): the window's wall time over the rounds it
completed, each round's block appended, on the host clock after a final
synchronize. The model owner pays for rounds until the target loss; one
round is one block."""


def read(run):
    if not run.rounds or run.device_trace is not None:
        return None
    return run.window_s / run.rounds * 1e3
