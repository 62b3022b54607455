"""Operations and bytes of the dropless MoE layer's grouped expert
products (``repro_torch.kernels.moe_grouped``), and their least time at
the H100's published peaks (``harness.counts``).

Every grouped product of the layer, forward or backward, multiplies its
rows by a d × f matrix of each group: the forward's X·W_gate, X·W_up and
H·W_down, the backward's dX-type products (rows × f by f × d, or rows ×
d by d × f) and its dW-type ones (d × rows by rows × f). So a launch
that computes r rows does 2·r·d·f operations, reads its rows' operand
(r·d or r·f) and writes its rows' result (r·f or r·d) — r·(d + f)
elements in all — and reads or writes the E held experts' d × f
matrices once, in bfloat16. Counted over L launches of R rows in all:
the rows' bytes are the same whatever the split, and the least time is
the larger of the operations over 989 TFLOP/s and the bytes over 3.35
TB/s (a launch of fewer rows can be no faster than its share).
"""

from __future__ import annotations

from perfbench.harness.counts import PEAK_BF16, bound_s

BF16 = 2


def grouped_flops(rows: int, d: int, f: int) -> float:
    return 2.0 * rows * d * f


def grouped_bytes(launches: int, rows: int, d: int, f: int,
                  experts: int) -> float:
    return BF16 * (rows * (d + f) + launches * experts * d * f)


def grouped_bound_s(launches: int, rows: int, d: int, f: int,
                    experts: int) -> float:
    """The least time of ``launches`` grouped products over ``rows`` rows
    in all, of the E = ``experts`` held experts' d × f matrices."""
    return bound_s(grouped_bytes(launches, rows, d, f, experts),
                   grouped_flops(rows, d, f), PEAK_BF16)
