"""Kimi K2 1T-A32B [arXiv:2501.kimi2] — 384-expert top-8 trillion-param MoE."""
from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    d_model=7168, n_layers=61, pattern=(LayerSpec("attn", moe=True),),
    n_heads=64, n_kv_heads=8, head_dim=112,
    vocab_size=163840,
    n_experts=384, experts_per_token=8, moe_d_ff=2048,
    capacity_factor=1.25,
    opt_state_dtype="bfloat16",   # 1T params: bf16 m/v (int8-Adam class tradeoff)
))
