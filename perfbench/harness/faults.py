"""Faults planted under the timed path, to show that the comparison
catches them (the benchmark's own runs plant none): a round that returns
its state unchanged; half of each cluster's batch left out, the mean
taken over the rest; an answer altered where it is produced (a loss,
Eq. 2's partials of one cluster, Eq. 2's partials given to the wrong
cluster, a vote weight from the tally, or a vote weight as the block
records it).
The cell runs on one card, so there is no exchange between chips to
leave out."""

from __future__ import annotations

import contextlib

from perfbench.harness.program import import_program


@contextlib.contextmanager
def _patched(module, name, make):
    inner = getattr(module, name)
    setattr(module, name, make(inner))
    try:
        yield
    finally:
        setattr(module, name, inner)


def unchanged_state():
    pt = import_program()["pt"]

    def make(inner):
        def pofel_round(model, state, *a, **kw):
            _, metrics = inner(model, state, *a, **kw)
            return state, metrics
        return pofel_round
    return _patched(pt, "pofel_round", make)


def half_batch():
    pt = import_program()["pt"]

    def make(inner):
        def local_step(model, params, batch, *a, **kw):
            # (C, B/C, S): half of each cluster's sequences, or of its
            # tokens where it has one sequence
            dim = 1 if batch["tokens"].shape[1] > 1 else 2

            def halve(key, v):
                if dim == 2 and key == "context":
                    return v
                return v.narrow(dim, 0, v.shape[dim] // 2)

            half = {k: halve(k, v) for k, v in batch.items()}
            return inner(model, params, half, *a, **kw)
        return local_step
    return _patched(pt, "local_step", make)


def altered_loss():
    pt = import_program()["pt"]

    def make(inner):
        def pofel_round(*a, **kw):
            state, m = inner(*a, **kw)
            return state, m._replace(loss=m.loss * 1.01)
        return pofel_round
    return _patched(pt, "pofel_round", make)


def _partials(make_out):
    ops = import_program()["ops"]

    def make(inner):
        def cosine_partials(W, gw):
            return make_out(*inner(W, gw))
        return cosine_partials
    return _patched(ops, "cosine_partials", make)


def altered_partials():
    """Eq. 2: the first cluster's <w_c, gw> a leaf 0.1 % low."""
    def out(dot, wsq, gsq):
        dot = dot.clone()
        dot[0] = dot[0] * 0.999
        return dot, wsq, gsq
    return _partials(out)


def wrong_row():
    """Eq. 2: each cluster given the next one's partials."""
    return _partials(lambda dot, wsq, gsq: (dot.roll(1), wsq.roll(1), gsq))


def altered_weights():
    pt = import_program()["pt"]

    def make(inner):
        def pofel_round(*a, **kw):
            state, m = inner(*a, **kw)
            w = m.vote_weights.clone()
            w[0] = w[0] * 1.5
            return state, m._replace(vote_weights=w)
        return pofel_round
    return _patched(pt, "pofel_round", make)


def altered_block():
    lt = import_program()["launch_train"]

    def make(inner):
        def append_round_block(ledger, keypair, round_, metrics):
            w = metrics.vote_weights.clone()
            w[0] = w[0] * 1.5
            return inner(ledger, keypair, round_,
                         metrics._replace(vote_weights=w))
        return append_round_block
    return _patched(lt, "append_round_block", make)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_loss": altered_loss, "altered_partials": altered_partials,
          "wrong_row": wrong_row, "altered_weights": altered_weights,
          "altered_block": altered_block}
