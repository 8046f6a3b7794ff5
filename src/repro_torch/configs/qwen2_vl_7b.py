"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf] — M-RoPE, vision frontend stubbed."""
from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    d_model=3584, n_layers=28, pattern=(LayerSpec("attn"),),
    n_heads=28, n_kv_heads=4, head_dim=128, qkv_bias=True,
    rope_theta=1_000_000.0, mrope_sections=(16, 24, 24),
    d_ff=18944, mlp_act="silu", vocab_size=152064,
    frontend="vision_stub",
))
