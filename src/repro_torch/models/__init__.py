"""The port's LM stack: the reference's models (layers, attention, Mamba,
MoE, blocks, model wrapper) for serving, prefill and decode."""
