"""DeepSeekMoE 16B: fine-grained experts — 2 shared + 64 routed top-6,
per-expert FFN dim 1408. [arXiv:2401.06066]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    n_experts=64, experts_per_token=6, n_shared_experts=2, moe_d_ff=1408,
    source="arXiv:2401.06066",
)
