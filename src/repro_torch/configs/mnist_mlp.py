"""The paper's own model (PoFEL §7.1): MLP 784-128-10 on MNIST-like data.
Represented as an ArchConfig for registry completeness; the FL runtime
uses repro_torch.models.mlp directly."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mnist-mlp", family="mlp",
    n_layers=2, d_model=128, n_heads=1, n_kv_heads=1, d_ff=128,
    vocab_size=10,
    source="PoFEL paper §7.1 (LeCun et al. 1998 MNIST)",
)
