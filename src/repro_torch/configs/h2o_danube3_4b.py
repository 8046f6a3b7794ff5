"""H2O-Danube-3-4B [arXiv:2401.16818] — llama+mistral mix with SWA."""
from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    d_model=3840, n_layers=24, pattern=(LayerSpec("attn", window=4096),),
    n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10240, mlp_act="silu", vocab_size=32000,
))
