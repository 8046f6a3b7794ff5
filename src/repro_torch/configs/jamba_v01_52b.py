"""Jamba-v0.1 52B [arXiv:2403.19887; hf] — Mamba+attn 1:7 interleave, MoE 16e top-2.

Pattern = one Jamba period of 8 layers (attn at offset 4), MoE on every other
layer (odd offsets), repeated 4x for 32 layers.
"""
from .base import ArchConfig, LayerSpec, register

_period = tuple(
    LayerSpec(kind=("attn" if i == 4 else "mamba"), moe=(i % 2 == 1))
    for i in range(8)
)

CONFIG = register(ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    d_model=4096, n_layers=32, pattern=_period,
    n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, mlp_act="silu", vocab_size=65536,
    n_experts=16, experts_per_token=2, moe_d_ff=14336,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
))
