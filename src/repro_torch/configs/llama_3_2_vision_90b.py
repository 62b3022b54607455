"""Llama-3.2-Vision 90B text backbone: 100 layers with gated cross-attention
image layers every 5th layer; vision encoder stubbed (input_specs provides
patch embeddings). [hf:meta-llama/Llama-3.2-11B-Vision, scaled per brief]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    cross_attn_every=5, n_context_tokens=1024,
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
