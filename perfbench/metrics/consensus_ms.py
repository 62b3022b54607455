"""consensus_ms (ms; layer: the consensus, fl.pofel_trainer.consensus —
Eq. 1 and Eq. 2 through the ME kernels, then BTSV): the host clock
around the module's function with a synchronize on each side, the mean
a round. Moves round_ms."""


def read(run):
    n = run.span_counts.get("consensus")
    return run.span_totals["consensus"] / n * 1e3 if n else None
