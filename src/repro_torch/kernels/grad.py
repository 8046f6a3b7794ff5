"""A gradient for the LM kernels K4 (Mamba scan) and K5 (RMSNorm), and the
dispatcher operators of K3, K4 and K5.  K3 (flash attention) has a backward
kernel of its own (``kernels.flash_attention.FlashAttentionFunction``).

:class:`PlainBackward` is a ``torch.autograd.Function`` whose forward calls
the kernel's launch, exactly as without autograd, and whose backward
recomputes the module's plain version under ``torch.enable_grad()`` on the
saved inputs and returns ``torch.autograd.grad`` of it.  The reference has
no backward Pallas kernel, and its models never call their kernels, so the
plain path under autograd is the parity target.

:func:`through_kernel` takes the Function only when autograd would record
the call (grad mode on and an input that requires grad).  Otherwise it
calls the launch directly: one launch, nothing saved.  That is so under
``torch.no_grad()``, which :func:`repro_torch.serve.generate` runs in, and
wherever no input requires grad.

A stop-gap until K4 and K5 get backward kernels: the backward costs the
plain version's forward and backward, for K4 an L-step Python loop that
keeps every step's (B, Di, N) state.  Each backward runs inside a profiler range named
``repro_torch/plain_backward/<plain version>``, so that a trace gives the
stop-gap's device time per kernel (``chip_smoke.py``'s training phases
read it); outside a profiler the range costs a few microseconds a call.

:func:`kernel_op` defines a kernel's launch as an operator of PyTorch's
dispatcher, so that ``FakeTensorMode`` can trace the card's program (the
dry run, :mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.autograd.function import once_differentiable

__all__ = ["PlainBackward", "through_kernel", "compute_dtype", "kernel_op"]

#: the ``repro_torch`` operators' definitions (alive as long as the process)
_LIBRARY = torch.library.Library("repro_torch", "FRAGMENT")


def compute_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic type: float32, or float64 for float64
    inputs (which no kernel takes; it lets ``gradcheck`` run on them)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


class PlainBackward(torch.autograd.Function):
    """forward: ``launch(*tensors, **kwargs)``; backward: the gradient of
    ``plain(*tensors, **kwargs)`` at the saved inputs."""

    @staticmethod
    def forward(ctx, launch: Callable, plain: Callable, kwargs: dict,
                *tensors):
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        return launch(*tensors, **kwargs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[3:]
        with torch.profiler.record_function(
                f"repro_torch/plain_backward/{ctx.plain.__name__}"):
            with torch.enable_grad():
                inputs = [t.detach().requires_grad_(n)
                          for t, n in zip(ctx.saved_tensors, need)]
                out = ctx.plain(*inputs, **ctx.kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            wrt = [t for t, n in zip(inputs, need) if n]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True) if pairs else [None] * len(wrt))
            return (None, None, None,
                    *(next(got) if n else None for n in need))


def through_kernel(launch: Callable, plain: Callable, tensors: tuple,
                   **kwargs):
    """``launch(*tensors, **kwargs)``, through :class:`PlainBackward` when
    autograd would record the call."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return PlainBackward.apply(launch, plain, kwargs, *tensors)
    return launch(*tensors, **kwargs)


def kernel_op(schema: str, launch: Callable, fake: Callable):
    """Define the operator ``repro_torch::<schema>`` with ``launch`` as its
    CUDA implementation, no other device's (a CPU tensor raises
    ``NotImplementedError``), and ``fake`` as its fake implementation (the
    outputs' shapes and dtypes); return it (the ``OpOverload``).

    A plain ``torch.library.Library`` definition: one dispatch into a
    Python call.  ``torch.library.custom_op`` would add its own autograd
    and aliasing layers around the launch, ~20 µs a call on the host, and
    :class:`PlainBackward` gives the gradient already."""
    name = schema.split("(", 1)[0]
    _LIBRARY.define(schema)
    _LIBRARY.impl(name, launch, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIBRARY)
    return getattr(torch.ops.repro_torch, name).default
