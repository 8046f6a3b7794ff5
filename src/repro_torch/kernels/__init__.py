"""Hand-written Hopper kernels of the port (sources in ``csrc/``), each with
its plain PyTorch version beside it."""
