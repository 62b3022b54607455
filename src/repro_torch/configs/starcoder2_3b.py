"""StarCoder2-3B: dense GQA (kv=2), RoPE, biases. [arXiv:2402.19173]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, head_dim=128,
    d_ff=12288, vocab_size=49152, qkv_bias=True,
    rope_theta=100000.0,
    source="arXiv:2402.19173",
)
