"""Zamba2-7B: Mamba2 backbone + shared attention block every 6th layer
(81 layers = 13 x (5 mamba + shared attn) + 3 mamba). ssm_state=64.
[arXiv:2411.15242]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6,
    source="arXiv:2411.15242",
)
