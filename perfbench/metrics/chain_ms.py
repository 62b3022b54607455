"""chain_ms (ms; layer: the chain, launch.train.append_round_block →
blockchain.ledger and core.crypto): the host clock around the call (the
consensus metrics already on the host), the mean a round. Moves
round_ms."""


def read(run):
    n = run.span_counts.get("chain")
    return run.span_totals["chain"] / n * 1e3 if n else None
