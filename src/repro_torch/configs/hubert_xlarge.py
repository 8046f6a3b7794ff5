"""HuBERT-XLarge [arXiv:2106.07447] — encoder-only audio (w2v2 arch), frontend stubbed."""
from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge", family="audio",
    d_model=1280, n_layers=48, pattern=(LayerSpec("attn"),),
    n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, mlp_act="gelu", vocab_size=504,
    causal=False, frontend="audio_stub",
))
