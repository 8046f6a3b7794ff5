"""Kernel K4 at a Di whose rows do not start on 16 bytes: its narrower copy
widths against padding Di to a 16-byte row.

K4 (``src/repro_torch/kernels/csrc/mamba_scan.cu``) copies rows of x, dt
and y in 16-, 8- or 4-byte pieces, the widest on which every row starts.
The other design would keep only the 16-byte width and have the wrapper pad
Di to a multiple of 16 bytes.  For each ragged form this times, with CUDA
events on one card:

* ``as_is_ms``: ``mamba_scan_cuda`` as it is (the narrower width);
* ``padded_ms``: zero-pad x, dt, A and D to the 16-byte row, the same call
  (16-byte width), and slice y and h_final back, as such a wrapper would;
* ``padded_kernel_ms``: the call alone on inputs padded beforehand.

and checks that both ways give the same bits.  Run on the card::

    PYTHONPATH=src python tools/k4_row_widths.py

Prints the card's name and power limit, then one JSON object per form.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels import mamba_scan as K4

FORMS = (
    ("ragged L=1000 Di=8100 bf16", (4, 1000, 8100, 16), torch.bfloat16),
    ("N 5 ragged L=1000 Di=4099 bf16", (2, 1000, 4099, 5), torch.bfloat16),
    ("ragged L=1000 Di=8190 f32", (4, 1000, 8190, 16), torch.float32),
    ("ragged L=1000 Di=4099 f32", (2, 1000, 4099, 16), torch.float32),
)


def _ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` timed calls after two warm-ups, ms."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for form, (B, L, Di, N), dt in FORMS:
        x = torch.randn(B, L, Di, generator=g, device=dev).to(dt)
        delta = F.softplus(torch.randn(B, L, Di, generator=g, device=dev)
                           * 0.5 - 1.0).to(dt)
        A = -torch.exp(torch.rand(Di, N, generator=g, device=dev) * 3 - 1)
        B_t, C_t = (torch.randn(B, L, N, generator=g, device=dev).to(dt)
                    for _ in range(2))
        D = torch.ones(Di, device=dev)
        pad = -Di % (16 // x.element_size())

        def padded_inputs():
            return (F.pad(x, (0, pad)), F.pad(delta, (0, pad)),
                    F.pad(A, (0, 0, 0, pad)), B_t, C_t, F.pad(D, (0, pad)))

        def padded():
            y, h = K4.mamba_scan_cuda(*padded_inputs())
            return y[..., :Di].contiguous(), h[:, :Di].contiguous()

        def as_is():
            return K4.mamba_scan_cuda(x, delta, A, B_t, C_t, D)

        pre = padded_inputs()
        y0, h0 = as_is()
        y1, h1 = padded()
        same = bool(torch.equal(y0, y1) and torch.equal(h0, h1))
        print(json.dumps(dict(
            form=form, shape=[B, L, Di, N], dtype=str(dt)[6:],
            row_bytes=Di * x.element_size(), padded_di=Di + pad,
            as_is_ms=_ms(as_is), padded_ms=_ms(padded),
            padded_kernel_ms=_ms(lambda: K4.mamba_scan_cuda(*pre)),
            same_bits=same)), flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
