"""Falcon-Mamba-7B [arXiv:2410.05355] — pure Mamba-1, attention-free."""
from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    d_model=4096, n_layers=64, pattern=(LayerSpec("mamba"),),
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
))
