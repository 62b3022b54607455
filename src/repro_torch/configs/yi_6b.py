"""Yi-6B: llama-architecture dense GQA (kv=4). [arXiv:2403.04652]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000,
    rope_theta=5000000.0,
    source="arXiv:2403.04652",
)
