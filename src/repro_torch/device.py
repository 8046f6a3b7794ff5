"""Device resolution shared by every entry point of the port.

Entry points take ``device=`` and default to ``"cuda"``.  Without a card they
raise instead of carrying on on the CPU; the CPU runs only when the caller
asks for it (the tests do).
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = DEFAULT_DEVICE
                   ) -> torch.device:
    """``device`` as a :class:`torch.device`; raises RuntimeError for a CUDA
    device when CUDA is unavailable.

    For CUDA it also pins float32 matrix products to full float32
    (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default,
    stated here because the Lanczos reorthogonalization GEMVs lose
    orthogonality at TF32's ~3 decimal digits).
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA is not available; pass device='cpu' to "
                "run the plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
