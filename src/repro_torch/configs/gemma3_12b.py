"""Gemma-3-12B class [hf:google/gemma-3] — 5:1 local:global attention, GeGLU."""
from .base import ArchConfig, LayerSpec, register

_period = tuple(LayerSpec("attn", window=1024) for _ in range(5)) + (LayerSpec("attn"),)

CONFIG = register(ArchConfig(
    name="gemma3-12b", family="dense",
    d_model=3840, n_layers=48, pattern=_period,
    n_heads=16, n_kv_heads=8, head_dim=256,
    rope_theta=1_000_000.0,
    d_ff=15360, mlp_act="gelu", vocab_size=262144,
    tie_embeddings=True,
))
