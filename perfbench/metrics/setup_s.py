"""setup_s (s, lower): from the process's start to the window's start:
reaching the card, loading (or, in a checkout's first run, building) the
kernels, making the weights and the batches, and the checked rounds that
warm every shape the window runs."""


def read(run):
    return run.setup_s if run.device_trace is None else None
