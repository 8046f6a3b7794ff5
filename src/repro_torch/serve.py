"""Serving loop of the LM stack: batched prefill, then decode.

The port of ``examples/serve_lm.py``'s loop as a function, :func:`generate`,
plus a command-line entry point::

    PYTHONPATH=src python -m repro_torch.serve --arch jamba-v0.1-52b \\
        --requests 4 --prompt-len 1024 --max-new 32 --layers 16

    PYTHONPATH=src python -m repro_torch.serve --arch jamba-v0.1-52b \\
        --reduced --device cpu

    PYTHONPATH=src python -m repro_torch.serve --arch qwen2-vl-7b \\
        --reduced --device cpu --temperature 0.8

On the card (the default device) the model runs at the config's published
widths, with random weights drawn from ``--seed``; ``--layers`` cuts the
depth to a multiple of the config's pattern and is listed in the output
(``reduced`` says what was cut).  ``--reduced`` serves the reference's
``reduced`` config (tiny widths) instead, which runs on the CPU.  As in the
example, one key, ``PRNGKey(--seed)`` (:mod:`repro_torch.core.threefry`,
the reference's ``jax.random`` draws bit for bit), draws the prompts: token
ids, or for a stub-frontend config (a vision or audio stub, such as
qwen2-vl-7b's) (B, S, D) embeddings, and each decode step's embedding of
such a config; ``--temperature`` above 0 samples each decode step's token
from the logits over the temperature, else the argmax.  The output is one
JSON object: the cut, the prefill and decode times and the generated
tokens.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import threefry
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import model as M

__all__ = ["ServeResult", "generate", "serving_config", "serving_prompts",
           "main"]

#: the example's fold-in offset of the sampling keys: step i samples with
#: ``fold_in(key, SAMPLE_FOLD + i)``, its embedding uses ``fold_in(key, i)``
SAMPLE_FOLD = 100


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, max_new) tokens
    prefill_logits: torch.Tensor  # (B, V) f32 logits of the last prompt position
    prefill_s: float
    decode_s: float               # all max_new - 1 decode steps

    @property
    def decode_steps(self) -> int:
        return self.tokens.shape[1] - 1


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def generate(params: Dict[str, Any], cfg, prompts: torch.Tensor,
             max_new: int, *, temperature: float = 0.0,
             key: threefry.Key = 0) -> ServeResult:
    """Prefill ``prompts`` as one batch -- token ids (B, S), or (B, S, D)
    embeddings for a stub-frontend config -- then ``max_new - 1`` decode
    steps: ``max_new`` new tokens per request, as the reference's serving
    example makes them.  The first token is the prefill's argmax.  Decode
    step i of a stub-frontend config is fed ``normal(fold_in(key, i), (B,
    D))`` (never the sampled token); with ``temperature > 0`` its token
    is ``categorical(fold_in(key, 100 + i), logits / temperature)``, else
    the argmax.  Runs under ``torch.no_grad()``, so each kernel call is one
    launch that saves nothing, whatever the parameters' ``requires_grad``.
    Times are host seconds around work that ends in a device
    synchronize."""
    if not cfg.causal:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    if max_new < 1:
        raise ValueError("max_new must be >= 1")
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    stub = cfg.frontend != "none"
    if prompts.dim() != (3 if stub else 2):
        want = "(B, S, D) embeddings" if stub else "(B, S) token ids"
        raise ValueError(f"{cfg.name} takes {want}, got shape "
                         f"{tuple(prompts.shape)}")
    dev = prompts.device
    B, S = prompts.shape[:2]
    _sync(dev)
    t0 = time.perf_counter()
    batch = {"embeds" if stub else "tokens": prompts}
    logits, caches = M.prefill(params, batch, cfg, max_len=S + max_new)
    tok = torch.argmax(logits, dim=-1)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    outs = [tok]
    t0 = time.perf_counter()
    for i in range(max_new - 1):
        feed = (threefry.normal(threefry.fold_in(key, i), (B, cfg.d_model),
                                dev) if stub else tok)
        step_logits, caches = M.decode_step(params, feed, caches, S + i, cfg)
        if temperature > 0:
            # a division by a device scalar: the card's division by a host
            # scalar multiplies by its reciprocal, which rounds otherwise
            scaled = step_logits / step_logits.new_full((), temperature)
            tok = threefry.categorical(
                threefry.fold_in(key, SAMPLE_FOLD + i), scaled)
        else:
            tok = torch.argmax(step_logits, dim=-1)
        outs.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return ServeResult(torch.stack(outs, dim=1), logits, prefill_s, decode_s)


def serving_prompts(cfg, B: int, S: int, key: threefry.Key,
                    device) -> torch.Tensor:
    """The example's prompts from ``key``: ``randint(key, (B, S), 0, V)``
    token ids, or ``normal(key, (B, S, D))`` embeddings for a
    stub-frontend config."""
    if cfg.frontend != "none":
        return threefry.normal(key, (B, S, cfg.d_model), device)
    return torch.from_numpy(threefry.randint(
        key, (B, S), 0, cfg.vocab_size).astype(np.int64)).to(device)


def serving_config(arch: str, layers: Union[int, None] = None,
                   use_reduced: bool = False):
    """``arch``'s config, or its ``reduced`` form, with depth cut to
    ``layers`` (a multiple of the pattern length) when given."""
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    if layers is not None and layers != cfg.n_layers:
        if layers <= 0 or layers % len(cfg.pattern):
            raise ValueError(f"--layers {layers}: must be a positive multiple "
                             f"of {cfg.name}'s pattern of {len(cfg.pattern)}")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="jamba-v0.1-52b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut depth to this many layers (pattern multiple)")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced config (tiny widths)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sample decode tokens at this temperature "
                         "(0: greedy)")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights, and PRNGKey(seed) for the prompts, "
                         "stub embeddings and samples")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    full = get_config(args.arch)
    cfg = serving_config(args.arch, args.layers, args.reduced)
    if not cfg.causal:
        raise SystemExit(f"{args.arch} is encoder-only: no decode step")
    params = M.init_params(cfg, seed=args.seed, device=dev)
    key = threefry.prng_key(args.seed)
    prompts = serving_prompts(cfg, args.requests, args.prompt_len, key, dev)
    res = generate(params, cfg, prompts, args.max_new,
                   temperature=args.temperature, key=key)
    base = reduced(full) if args.reduced else full
    cut = ["reduced config (tiny widths, experts, vocab)"] if args.reduced else []
    if cfg.n_layers != base.n_layers:
        cut.append(f"layers {cfg.n_layers} of {base.n_layers}")
    ntok = args.requests * res.decode_steps
    out = dict(
        arch=args.arch, config=cfg.name, n_layers=cfg.n_layers,
        reduced=cut, device=str(dev),
        device_name=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
        requests=args.requests, prompt_len=args.prompt_len,
        max_new=args.max_new, seed=args.seed, temperature=args.temperature,
        frontend=cfg.frontend,
        prefill_ms=res.prefill_s * 1e3,
        prefill_tokens_per_s=args.requests * args.prompt_len / res.prefill_s,
        decode_ms_per_step=(res.decode_s / res.decode_steps * 1e3
                            if res.decode_steps else None),
        decode_tokens_per_s=(ntok / res.decode_s if res.decode_steps else None),
        tokens=res.tokens.tolist())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
