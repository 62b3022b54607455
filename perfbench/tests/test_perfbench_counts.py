"""The FLOP and byte counts against hand counts at a reduced size."""

import pytest

from perfbench.harness import counts
from perfbench.reference import transformer

TINY_AUDIO = dict(reference="transformer", family="audio", n_layers=1,
                  d_model=4, n_heads=2, n_kv_heads=2, head_dim=2, d_ff=6,
                  vocab_size=10, n_context_tokens=3)


@pytest.mark.parametrize("S,causal,window,Skv,pairs", [
    (5, True, 0, None, 15),          # 1 + 2 + 3 + 4 + 5
    (5, True, 2, None, 9),           # 1 + 2 + 2 + 2 + 2
    (5, True, 8, None, 15),          # a window past S keeps every pair
    (3, False, 0, 4, 12),            # keys of their own length
])
def test_unmasked_pairs(S, causal, window, Skv, pairs):
    assert counts.unmasked_pairs(S, causal, window, Skv) == pairs


def test_transformer_forward_by_hand():
    # one sequence of 2 tokens, D 4, 2 heads of 2, d_ff 6, V 10, Nc 3
    self_proj = 2 * 4 * (2 * 4 * 4)        # wq, wk, wv, wo: 2·D·D a token
    self_attn = 3 * 4 * 2 * 2              # 3 causal pairs × 4·hd × H
    cross_q_o = 2 * 2 * (2 * 4 * 4)        # wq, wo on the 2 tokens
    cross_k_v = 3 * 2 * (2 * 4 * 4)        # wk, wv on the 3 context frames
    cross_attn = 2 * 3 * 4 * 2 * 2         # S·Nc pairs × 4·hd × H
    mlp = 2 * 3 * (2 * 4 * 6)              # gate, up, down
    head = 2 * 2 * 4 * 10
    want = (self_proj + self_attn + cross_q_o + cross_k_v + cross_attn
            + mlp + head)
    assert transformer.forward_flops(TINY_AUDIO, 1, 2) == want
    traffic = {"clusters": 1, "seqs_per_cluster": 1, "seq_len": 2}
    assert counts.round_model_flops(TINY_AUDIO, traffic) == 3 * want


def test_dense_transformer_leaves_out_cross_attention():
    dense = dict(TINY_AUDIO, family="dense")
    audio = transformer.forward_flops(TINY_AUDIO, 1, 2)
    assert transformer.forward_flops(dense, 1, 2) == \
        audio - (2 * 2 * 32 + 3 * 2 * 32 + 2 * 3 * 16)


def test_flash_bounds_by_hand():
    # bf16, B 1, Sq 4, Skv 4, 2 heads of 8, causal: 10 pairs a head
    flops = 4 * 8 * 2 * 10
    n_bytes = (2 * 4 * 2 * 8 + 2 * 4 * 2 * 8) * 2
    want = max(flops / counts.PEAK_BF16, n_bytes / counts.HBM)
    assert counts.flash_fwd_bound_s(1, 4, 4, 2, 2, 8, "bfloat16", True,
                                    0) == pytest.approx(want)
    flops_b = 10 * 8 * 2 * 10
    bytes_b = (4 * 4 * 2 * 8 + 4 * 4 * 2 * 8) * 2 + 4 * 2 * 4
    want_b = max(flops_b / counts.PEAK_BF16, bytes_b / counts.HBM)
    assert counts.flash_bwd_bound_s(1, 4, 4, 2, 2, 8, "bfloat16", True,
                                    0) == pytest.approx(want_b)


def test_me_bounds_by_hand():
    # Eq. 1 over C = 4 bf16 rows of n = 100: rows, λ, a float32 gw
    assert counts.weighted_agg_bound_s(4, 100, 2) == pytest.approx(
        (4 * 100 * 2 + 4 * 4 + 4 * 100) / counts.HBM)
    # Eq. 2: rows and gw in the leaf's dtype, 2C + 1 float32 partials
    assert counts.cosine_partials_bound_s(4, 100, 2) == pytest.approx(
        (4 * 100 * 2 + 100 * 2 + 4 * 9) / counts.HBM)
