"""The port's step functions: one training step, prefill and decode."""
