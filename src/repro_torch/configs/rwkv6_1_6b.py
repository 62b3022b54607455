"""RWKV-6 'Finch' 1.6B: attention-free, data-dependent decay, O(1) decode
state. [arXiv:2404.05892]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,  # heads = d/64
    d_ff=7168, vocab_size=65536,
    rwkv=True, rwkv_head_size=64,
    source="arXiv:2404.05892",
)
