"""backward_alloc_gib (GiB; layer: the FEL step): a round's peak of
allocated bytes less those allocated when ``Model.loss``'s forward
returns (under ``vmap(grad_and_value)``): what the backward, the stacked
leaves' gradients and the SGD update add on top of the forward. The
largest over the traced run's timed rounds. Moves peak_mem_gib."""


def read(run):
    b = run.backward_alloc_bytes
    return None if b is None else b / 2 ** 30
