"""Gemma-2B [arXiv:2403.08295; hf] — GeGLU, head_dim=256, MQA (kv=1)."""
from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="gemma-2b", family="dense",
    d_model=2048, n_layers=18, pattern=(LayerSpec("attn"),),
    n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, mlp_act="gelu", vocab_size=256000,
    tie_embeddings=True,
))
