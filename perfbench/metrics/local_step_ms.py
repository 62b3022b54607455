"""local_step_ms (ms; layer: the FEL step, fl.pofel_trainer.local_step):
the host clock around the module's function with a synchronize on each
side, the mean over the traced run's timed rounds. Moves round_ms."""


def read(run):
    n = run.span_counts.get("local_step")
    return run.span_totals["local_step"] / n * 1e3 if n else None
