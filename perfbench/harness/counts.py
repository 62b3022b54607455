"""Operations and bytes: the model's FLOPs a round (each family's
forward counted by its plain reference's ``forward_flops``) and each
kernel's least time, with the H100's published peaks.

Copied from the port's ``launch/costs.py`` and ``chip_smoke.py``'s
``*_bound_us`` and corrected for a model-FLOP share:

* a weight matrix counts 2 FLOPs for each token it multiplies; the
  cross-attention's K and V projections multiply the context's tokens;
* attention counts 4·hd for each unmasked (query, key) pair: a causal
  self-attention S(S+1)/2 pairs a head, a cross-attention S·Nc;
* a round is 3 × the forward (forward and backward), and leaves out the
  remat recompute, the embedding lookup, the consensus and the SGD
  update.

Least times read the inputs once and write the outputs once and take the
fewest operations the function needs: 4·hd (flash forward) and 10·hd
(its backward) a pair, at 989 TFLOP/s (bf16 tensor cores) or 67 TFLOP/s
(float32) and 3.35 TB/s (NVIDIA's H100 SXM data sheet, dense, 700 W).
"""

from __future__ import annotations

PEAK_BF16 = 989e12        # FLOP/s, tensor cores, dense
PEAK_FP32 = 67e12         # FLOP/s, CUDA cores
HBM = 3.35e12             # bytes/s

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(n_bytes: float, flops: float, flop_per_s: float) -> float:
    """The least time: the larger of operations over the peak rate and
    bytes over the memory bandwidth."""
    return max(n_bytes / HBM, flops / flop_per_s)


def unmasked_pairs(S: int, causal: bool, window: int = 0,
                   Skv: int | None = None) -> int:
    """(query, key) pairs the masks keep: S queries to S keys (causal,
    optionally within a window) or to ``Skv`` keys."""
    Skv = S if Skv is None else Skv
    if not causal:
        if window:
            raise ValueError("a window only with causal attention")
        return S * Skv
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    # queries 0..window-1 see q+1 keys, the rest see `window`
    return window * (window + 1) // 2 + (S - window) * window


def flash_fwd_bound_s(B, Sq, Skv, Hq, Hk, hd, dtype, causal, window
                      ) -> float:
    size = DTYPE_BYTES[dtype]
    n_bytes = (2 * B * Sq * Hq * hd + 2 * B * Skv * Hk * hd) * size
    flops = 4.0 * hd * B * Hq * unmasked_pairs(Sq, causal, window, Skv)
    return bound_s(n_bytes, flops, PEAK_BF16 if size == 2 else PEAK_FP32)


def flash_bwd_bound_s(B, Sq, Skv, Hq, Hk, hd, dtype, causal, window
                      ) -> float:
    size = DTYPE_BYTES[dtype]
    n_bytes = (4 * B * Sq * Hq * hd + 4 * B * Skv * Hk * hd) * size \
        + 4 * B * Hq * Sq
    flops = 10.0 * hd * B * Hq * unmasked_pairs(Sq, causal, window, Skv)
    return bound_s(n_bytes, flops, PEAK_BF16 if size == 2 else PEAK_FP32)


def weighted_agg_bound_s(C: int, n: int, size: int) -> float:
    """Eq. 1 on a leaf's (C, n) rows: read the rows and λ, write gw
    (float32)."""
    return (C * n * size + 4 * C + 4 * n) / HBM


def cosine_partials_bound_s(C: int, n: int, size: int) -> float:
    """Eq. 2's partials on a leaf: read the (C, n) rows and gw (the
    leaf's dtype), write 2C + 1 float32 partials."""
    return (C * n * size + n * size + 4 * (2 * C + 1)) / HBM


def round_model_flops(arch: dict, traffic: dict) -> float:
    """Model FLOPs of one trainer round: 3 × the forward (the family's
    ``forward_flops``) over every cluster's sequences."""
    from perfbench.harness.weights import model_reference
    n = traffic["clusters"] * traffic["seqs_per_cluster"]
    return 3.0 * model_reference(arch).forward_flops(arch, n,
                                                     traffic["seq_len"])
