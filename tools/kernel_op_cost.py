"""Per-call cost of reaching K3 / K4 / K5 through their dispatcher operators
rather than calling their ctypes launch directly, on the card.

    PYTHONPATH=src python tools/kernel_op_cost.py [--reps 400] [--steps 20]

Three ways to reach each kernel's launch, measured in turns (direct,
library, custom_op, custom_op, library, direct) in one process, every
figure a median over the turns:

* ``direct``: each module's operator swapped for its launch function (the
  call path before the operators);
* ``library``: the package as it is, a ``torch.library.Library``
  definition (``kernels.grad.kernel_op``);
* ``custom_op``: the same launch behind a ``torch.library.custom_op``
  defined here (namespace ``repro_torch_cost``), the other way
  ``torch.library`` registers an operator.

Four measurements:

* K5 at its table form, (4096, 4096) bf16, and at a decode step's form,
  (4, 3584) bf16: the wall time of ``reps`` back-to-back wrapper calls
  (``rmsnorm_cuda``) ended by one synchronize, per call;
* a qwen2-7b decode step at its published widths (28 layers, B 4, a
  1024-token prompt's caches, bf16, random weights from seed 0) and a
  jamba-v0.1-52b decode step at the smoke's serving size (16 of 32 layers,
  B 4, 1024-token prompts): the wall time of one ``make_decode_step`` call
  ended by a synchronize, ``steps`` of them a turn.  Decode reaches K5 at
  every norm (the launches a step are printed); its attention and Mamba
  step are plain.

Prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import time

import torch

VARIANTS = ("direct", "library", "custom_op")


def _custom_ops(K3, K4, K5) -> dict:
    """Each kernel's launch behind a ``torch.library.custom_op``."""
    ns = "repro_torch_cost"

    @torch.library.custom_op(f"{ns}::rmsnorm", mutates_args=(),
                             device_types="cuda",
                             schema="(Tensor x, Tensor w, float eps) -> Tensor")
    def rmsnorm(x, w, eps):
        return K5._launch(x, w, eps)

    @torch.library.custom_op(
        f"{ns}::flash_attention", mutates_args=(), device_types="cuda",
        schema="(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor")
    def flash_attention(q, k, v, causal):
        return K3._launch(q, k, v, causal=causal)

    @torch.library.custom_op(
        f"{ns}::mamba_scan", mutates_args=(), device_types="cuda",
        schema="(Tensor x, Tensor delta, Tensor A, Tensor B_t, Tensor C_t, "
               "Tensor D) -> (Tensor, Tensor)")
    def mamba_scan(x, delta, A, B_t, C_t, D):
        return K4._launch(x, delta, A, B_t, C_t, D)

    return dict(rmsnorm=rmsnorm, flash_attention=flash_attention,
                mamba_scan=mamba_scan)


@contextlib.contextmanager
def _variant(which: str, K3, K4, K5, custom: dict):
    """The wrappers reach their launches the ``which`` way."""
    saved = (K3.flash_attention_op, K4.mamba_scan_op, K5.rmsnorm_op)
    if which == "direct":
        K3.flash_attention_op = lambda q, k, v, causal: K3._launch(
            q, k, v, causal=causal)
        K4.mamba_scan_op = K4._launch
        K5.rmsnorm_op = K5._launch
    elif which == "custom_op":
        K3.flash_attention_op = custom["flash_attention"]
        K4.mamba_scan_op = custom["mamba_scan"]
        K5.rmsnorm_op = custom["rmsnorm"]
    try:
        yield
    finally:
        K3.flash_attention_op, K4.mamba_scan_op, K5.rmsnorm_op = saved


def _per_call_us(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def _turns(measure, K3, K4, K5, custom) -> dict:
    """measure() in turns: each variant, then each again in reverse."""
    got = {v: [] for v in VARIANTS}
    for which in VARIANTS + VARIANTS[::-1]:
        with _variant(which, K3, K4, K5, custom):
            got[which].append(measure())
    return {k: statistics.median(v) for k, v in got.items()} | dict(runs=got)


def _decode_row(arch: str, layers, K3, K4, K5, custom, steps: int, dev,
                gen) -> dict:
    """One config's decode step in turns, and its K5 launches a step."""
    from repro_torch.models.model import init_params
    from repro_torch.serve import serving_config
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    cfg = serving_config(arch, layers=layers)
    params = init_params(cfg, seed=0, device=dev)
    B, S = 4, 1024
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    _, caches = make_prefill_step(cfg, max_len=S + 1)(
        params, {"tokens": tokens})
    decode = make_decode_step(cfg)
    tok = tokens[:, -1]
    K5.reset_launches()
    decode(params, tok, caches, S)
    k5 = K5.launches()

    def step_ms():
        times = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(params, tok, caches, S)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    row = dict(n_layers=cfg.n_layers, k5_launches_a_step=k5,
               step_ms=_turns(step_ms, K3, K4, K5, custom))
    del params, caches
    torch.cuda.empty_cache()
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=400)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()

    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import mamba_scan as K4
    from repro_torch.kernels import rmsnorm as K5

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    custom = _custom_ops(K3, K4, K5)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = dict(nvidia_smi=smi, reps=args.reps, steps=args.steps)
    with torch.no_grad():
        for name, (R, D) in (("k5_table_4096x4096_bf16", (4096, 4096)),
                             ("k5_decode_4x3584_bf16", (4, 3584))):
            x = torch.randn(R, D, generator=gen, device=dev).bfloat16()
            w = torch.randn(D, generator=gen, device=dev).bfloat16()
            out[name + "_us_per_call"] = _turns(
                lambda: _per_call_us(lambda: K5.rmsnorm_cuda(x, w),
                                     args.reps), K3, K4, K5, custom)
        out["qwen2_7b_decode"] = _decode_row("qwen2-7b", None, K3, K4, K5,
                                             custom, args.steps, dev, gen)
        out["jamba_16_layers_decode"] = _decode_row(
            "jamba-v0.1-52b", 16, K3, K4, K5, custom, args.steps, dev, gen)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
