"""mfu (%; layer: the model step, models.model_api.Model.loss under
vmap(grad_and_value)): the model FLOPs of a round (3 × the forward, no
remat recompute, no embedding lookup, consensus or update:
harness.counts) over the mean round of the traced run's timed rounds
times 989 TFLOP/s (bf16 dense, H100 SXM at 700 W; the card's power limit
is printed beside every result). Moves round_ms."""

from perfbench.harness import counts


def read(run):
    n = run.span_counts.get("round")
    if not n:
        return None
    round_s = run.span_totals["round"] / n
    return run.round_model_flops() / (round_s * counts.PEAK_BF16) * 100.0
