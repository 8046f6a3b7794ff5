"""Grok-1 314B [hf:xai-org/grok-1] — MoE 8e top-2, GQA kv=8."""
from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="grok-1-314b", family="moe",
    d_model=6144, n_layers=64, pattern=(LayerSpec("attn", moe=True),),
    n_heads=48, n_kv_heads=8, head_dim=128,
    vocab_size=131072,
    n_experts=8, experts_per_token=2, moe_d_ff=32768,
    opt_state_dtype="bfloat16",   # 314B: quantized optimizer states at 512 chips
))
