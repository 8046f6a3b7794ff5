"""~100M-param LM for the end-to-end CPU training example (not an assigned arch)."""
from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="lm100m", family="dense",
    d_model=640, n_layers=10, pattern=(LayerSpec("attn"),),
    n_heads=10, n_kv_heads=5, head_dim=64,
    d_ff=2560, mlp_act="silu", vocab_size=50257,
    param_dtype="float32", compute_dtype="float32",
))
