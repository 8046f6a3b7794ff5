"""Qwen2-7B [arXiv:2407.10671; hf] — GQA kv=4, QKV bias."""
from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="qwen2-7b", family="dense",
    d_model=3584, n_layers=28, pattern=(LayerSpec("attn"),),
    n_heads=28, n_kv_heads=4, head_dim=128, qkv_bias=True,
    rope_theta=1_000_000.0,
    d_ff=18944, mlp_act="silu", vocab_size=152064,
))
