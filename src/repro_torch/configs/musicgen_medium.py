"""MusicGen-medium: decoder-only transformer over EnCodec tokens with
cross-attention to conditioning embeddings in every layer; the EnCodec /
text frontend is stubbed (input_specs provides conditioning frames).
[arXiv:2306.05284]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    cross_attn_every=1, n_context_tokens=256,
    source="arXiv:2306.05284",
)
