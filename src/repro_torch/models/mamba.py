"""Mamba-1 selective SSM block (falcon-mamba / jamba substrate).

The port of the reference's ``models/mamba.py``.  Prefill: on the card the
selective scan is the hand-written kernel K4
(:mod:`repro_torch.kernels.mamba_scan`), which also returns the final state
for the decode cache; on the CPU it is ``selective_scan_chunked``, the time
chunks in order with an associative (or sequential) scan inside each chunk,
so the (B, L, d_inner, N) working set stays one chunk long.  Decode is a
single recurrence step over (conv_state, ssm_state), plain PyTorch
everywhere.

Sharded execution (DTensor inputs inside an ``activation_mesh``): u and z
are constrained to (batch, -, channels) as in the reference, moved there
from in_proj's column shards by the reference partitioner's four
permutes over the model axis (:class:`_HalvesExchange`; the product is
never gathered whole), and the
causal convolution and the scan run shard by shard
(:func:`repro_torch.parallel.act.per_shard`): batch and channels are
independent, time and the state are not.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import mamba_scan as K4
from repro_torch.parallel.act import (BATCH, TP, constrain,
                                      contract_shards, gathered_product,
                                      model_axis_size, per_shard, permute)

__all__ = ["mamba_params_shapes", "mamba_forward", "mamba_prefill",
           "mamba_decode_step", "selective_scan_chunked", "selective_scan_ref"]

_SCAN_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# --------------------------------------------------------------------------
# selective scan
# --------------------------------------------------------------------------

def _ssm_inputs(x, delta, A, B_t, C_t):
    """a_t = exp(delta_t A) (B,L,Di,N); b_t = delta_t * B_t * x_t."""
    a = torch.exp(delta[..., None] * A[None, None])               # (B,L,Di,N)
    b = (delta * x)[..., None] * B_t[:, :, None, :]               # (B,L,Di,N)
    return a, b


def selective_scan_ref(x, delta, A, B_t, C_t, D) -> torch.Tensor:
    """Naive sequential oracle: h_t = a_t h_{t-1} + b_t; y_t = C_t.h_t + D x_t.

    x/delta: (B, L, Di); A: (Di, N); B_t/C_t: (B, L, N); D: (Di,).
    """
    a, b = _ssm_inputs(x, delta, A, B_t, C_t)
    a, b, c = a.float(), b.float(), C_t.float()
    Bb, L, Di = x.shape
    h = torch.zeros((Bb, Di, A.shape[1]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        h = a[:, t] * h + b[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    out = torch.stack(ys, dim=1) + x.float() * D[None, None]
    return out.to(x.dtype)


def _assoc_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1):
    """Inclusive scan of h -> a*h + b along ``dim`` (log-depth doubling):
    returns (prod a, composed b) per position, the pair the reference's
    ``jax.lax.associative_scan`` gives with the same combine."""
    n = a.shape[dim]
    step = 1
    while step < n:
        a_prev = a.narrow(dim, 0, n - step)
        b_prev = b.narrow(dim, 0, n - step)
        a_cur = a.narrow(dim, step, n - step)
        b_cur = b.narrow(dim, step, n - step)
        a = torch.cat([a.narrow(dim, 0, step), a_prev * a_cur], dim=dim)
        b = torch.cat([b.narrow(dim, 0, step), a_cur * b_prev + b_cur], dim=dim)
        step *= 2
    return a, b


def selective_scan_chunked(x, delta, A, B_t, C_t, D, chunk: int = 256,
                           h0: Optional[torch.Tensor] = None,
                           scan_dtype: torch.dtype = torch.float32,
                           impl: str = "assoc"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan; returns (y, h_final).  Same math as selective_scan_ref."""
    Bb, L, Di = x.shape
    N = A.shape[1]
    chunk = min(chunk, L)
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        delta = F.pad(delta, (0, 0, 0, pad))
        B_t = F.pad(B_t, (0, 0, 0, pad))
        C_t = F.pad(C_t, (0, 0, 0, pad))
    Lp = L + pad
    h = (torch.zeros((Bb, Di, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    ys = []
    for c0 in range(0, Lp, chunk):
        xc, dc = x[:, c0:c0 + chunk], delta[:, c0:c0 + chunk]
        bc, cc = B_t[:, c0:c0 + chunk], C_t[:, c0:c0 + chunk]
        if impl == "seq":
            # time-sequential: a_t/b_t built per step, y emitted directly
            yc = []
            for t in range(xc.shape[1]):
                d_t = dc[:, t]
                a_t = torch.exp(d_t[..., None].float() * A[None])
                b_t = ((d_t * xc[:, t])[..., None].float()
                       * bc[:, t, None, :].float())
                h = a_t * h + b_t
                yc.append(torch.einsum("bdn,bn->bd", h, cc[:, t].float()))
            ys.append(constrain(torch.stack(yc, dim=1), BATCH, None, TP))
            continue
        a, b = _ssm_inputs(xc, dc, A, bc, cc)
        a = constrain(a.to(scan_dtype), BATCH, None, TP, None)
        b = constrain(b.to(scan_dtype), BATCH, None, TP, None)
        a_cum, b_cum = _assoc_scan(a, b)
        h_t = constrain(a_cum.float() * h[:, None] + b_cum.float(),
                        BATCH, None, TP, None)                     # (B,c,Di,N)
        ys.append(constrain(torch.einsum("bcdn,bcn->bcd", h_t, cc.float()),
                            BATCH, None, TP))
        h = h_t[:, -1]
    y = torch.cat(ys, dim=1)[:, :L]
    out = y + x[:, :L].float() * D[None, None]
    return out.to(x.dtype), h


def _scan_local(u, delta, A, B_t, C_t, D, *, chunk: int, impl: str,
                scan_dtype: torch.dtype):
    """The prefill scan on whole sequences: kernel K4 on the card, else the
    chunked plain scan."""
    if u.device.type == "cuda":
        return K4.mamba_scan_cuda(u, delta, A, B_t, C_t, D)
    return selective_scan_chunked(u, delta, A, B_t, C_t, D, chunk=chunk,
                                  scan_dtype=scan_dtype, impl=impl)


#: the scan's and the convolution's dims for per_shard: batch ("b") and
#: channels ("c") are independent, time ("l") and state ("n") are not
_SEQ = ("b", "l", "c")
_SCAN_DIMS = (_SEQ, _SEQ, ("c", "n"), ("b", "l", "n"), ("b", "l", "n"),
              ("c",))
_FREE = frozenset({"b", "c"})


def _scan(u, delta, A, B_t, C_t, D, cfg, impl: str = "assoc",
          scan_dtype: torch.dtype = torch.float32):
    """The prefill scan, shard by shard on DTensor inputs: (y, h_final)."""
    return per_shard(_scan_local, (u, delta, A, B_t, C_t, D), _SCAN_DIMS,
                     (_SEQ, ("b", "c", "n")), _FREE, chunk=cfg.mamba_chunk,
                     impl=impl, scan_dtype=scan_dtype)


# --------------------------------------------------------------------------
# full mamba block
# --------------------------------------------------------------------------

def mamba_params_shapes(cfg) -> Dict[str, tuple]:
    D, Di, N, R, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                      cfg.ssm_conv)
    return dict(in_proj=(D, 2 * Di), conv_w=(K, Di), conv_b=(Di,),
                x_proj=(Di, R + 2 * N), dt_proj=(R, Di), dt_bias=(Di,),
                A_log=(Di, N), D=(Di,), out_proj=(Di, D), norm=(D,))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along time via K shifted adds. x: (B, L, Di)."""
    K = w.shape[0]
    if state is not None:                       # prepend cached context
        x_ext = torch.cat([state, x], dim=1)
    else:
        x_ext = F.pad(x, (0, 0, K - 1, 0))
    L = x.shape[1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(K):
        y = y + x_ext[:, k:k + L].float() * w[k][None, None]
    return (y + b[None, None]).to(x.dtype)


def _matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the promoted dtype of the two, as jnp's matmul promotes
    (decode feeds f32 activations to bf16 projections)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _ssm_projections(params, u, cfg):
    N, R = cfg.ssm_state, cfg.dt_rank
    # (B, L, R+2N), whole on its last dim: with x_proj's Di rows on 'model'
    # the product is a partial sum there, which torch 2.11's DTensor cannot
    # add dt_bias's shard to after dt_proj; reduce it first.  The product
    # runs shard by shard, so its input gradient stays on each rank's own
    # Di shard (DTensor's own backward computes all of it on every rank)
    proj = constrain(contract_shards(_matmul, u, params["x_proj"]), BATCH,
                     None, None)
    dt, B_t, C_t = torch.split(proj, [R, N, N], dim=-1)
    delta = F.softplus(_matmul(dt, params["dt_proj"]) + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())
    return delta, A, B_t, C_t


def _halves_permutes(M: int) -> list:
    """The reference's lowering of the split of ``x @ in_proj``'s 2 w
    columns a model rank (M ranks, w = Di / M) into u's and z's w columns:
    four collective-permutes, as (source -> target pairs, the source's
    slots it sends, the slot the target takes, the half it fills), in
    XLA's order (its HLO of the reference's falcon-mamba-7b step at 16 x
    16).  Rank s holds u's blocks 2 s, 2 s + 1 below h = M / 2 and z's
    blocks 2 (s - h), 2 (s - h) + 1 from there (slots 0, 1); rank r takes
    u's and z's block r.  The first permute sends a rank's two slots
    whole, its target keeping one; rank 0 keeps its u block and rank M - 1
    its z block where they are."""
    h = M // 2
    return [
        ({0: 1, **{j: 2 * j for j in range(1, h)}}, (0, 1), None, "u"),
        ({j: 2 * j + 1 for j in range(1, h)}, (1,), 0, "u"),
        ({h + j: 2 * j for j in range(h)}, (0,), 0, "z"),
        ({h + j: 2 * j + 1 for j in range(h - 1)}, (1,), 0, "z"),
    ]


class _HalvesExchange(torch.autograd.Function):
    """A model rank's 2 w columns of ``x @ in_proj`` (B, L, 2 w), w = Di /
    M, to its own w columns of u and of z, moved as the reference's
    partitioner moves them (:func:`_halves_permutes`: 5 w columns a rank in
    four permutes, where one all-to-all of 2 w would do).  The backward
    sends each target's gradient back to the rank and slot its columns
    came from, w columns a permute, so the weight gradient stays on its
    own columns."""

    @staticmethod
    def forward(ctx, t, group, rank: int, M: int):
        w = t.shape[-1] // 2
        slots = (t[..., :w], t[..., w:])
        half = dict(u=slots[0] if rank == 0 else None,
                    z=slots[1] if rank == M - 1 else None)
        used = []
        for pairs, sent, take, name in _halves_permutes(M):
            if not pairs:
                continue
            got = permute(t if len(sent) == 2 else slots[sent[0]], pairs,
                           rank, M, group)
            if got is not None:
                if take is None:            # the whole pair of slots
                    take = 1 if rank == 1 else 0
                    got = got[..., take * w:(take + 1) * w]
                half[name] = got
            used.append((pairs, sent, name))
        ctx.exchange = (group, rank, M, used)
        return half["u"].contiguous(), half["z"].contiguous()

    @staticmethod
    def backward(ctx, du, dz):
        group, rank, M, used = ctx.exchange
        grads = dict(u=du, z=dz)
        slots = [None, None]
        if rank == 0:
            slots[0] = du
        if rank == M - 1:
            slots[1] = dz
        for pairs, sent, name in used:
            back = {d: s for s, d in pairs.items()}
            got = permute(grads[name], back, rank, M, group)
            if got is not None:
                slot = sent[-1] if len(sent) == 1 else (1 if rank == 0
                                                        else 0)
                slots[slot] = got
        return torch.cat(slots, dim=-1), None, None, None


def _split_in_proj(xz, Di: int):
    """u and z, (B, L, Di) each, from ``x @ in_proj`` (B, L, 2 Di).  On a
    mesh whose model axis (M > 1 ranks: even, dividing Di) shards the
    product's columns, the product stays on its shards and
    :class:`_HalvesExchange` moves each rank's halves to u's and z's own
    (B, L, Di / M) shards, as the reference's partitioner moves them (no
    rank gathers the whole product);
    elsewhere (off a mesh, or one model rank) the plain split."""
    from torch.distributed.tensor.experimental import local_map

    M = model_axis_size(xz)
    if M > 1:
        if M % 2 or Di % M:
            raise ValueError(f"mamba: a model axis of {M} ranks must be "
                             f"even and divide d_inner {Di} (each rank "
                             f"holds u's or z's columns of in_proj)")
        xz = constrain(xz, BATCH, None, TP)     # 'model' on the columns
        mesh = xz.device_mesh
        m = list(mesh.mesh_dim_names).index(TP)
        group, rank = (mesh, m), mesh.get_local_rank(m)
        run = local_map(lambda t: _HalvesExchange.apply(t, group, rank, M),
                        out_placements=(list(xz.placements),) * 2,
                        in_placements=(list(xz.placements),),
                        in_grad_placements=(list(xz.placements),),
                        device_mesh=mesh)
        return run(xz)
    xz = constrain(xz, BATCH, None, None)
    u, z = torch.split(xz, [Di, Di], dim=-1)
    return constrain(u, BATCH, None, TP), constrain(z, BATCH, None, TP)


def mamba_forward(params: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, L, D) -> (B, L, D)."""
    out, _ = mamba_prefill(params, x, cfg, impl=getattr(cfg, "ssm_impl",
                                                        "assoc"),
                           scan_dtype=_SCAN_DTYPES[getattr(
                               cfg, "ssm_scan_dtype", "float32")])
    return out


def mamba_prefill(params: Dict, x: torch.Tensor, cfg, impl: str = "assoc",
                  scan_dtype: torch.dtype = torch.float32
                  ) -> Tuple[torch.Tensor, Dict]:
    """Forward over the prompt, returning the decode cache."""
    Di, K = cfg.d_inner, cfg.ssm_conv
    u, z = _split_in_proj(x @ params["in_proj"], Di)
    conv_state = u[:, -(K - 1):, :]                               # raw inputs tail
    uc = F.silu(per_shard(_causal_conv, (u, params["conv_w"],
                                         params["conv_b"]),
                          (_SEQ, ("k", "c"), ("c",)), (_SEQ,), _FREE))
    delta, A, B_t, C_t = _ssm_projections(params, uc, cfg)
    y, h_final = _scan(uc, delta, A, B_t, C_t, params["D"].float(), cfg,
                       impl=impl, scan_dtype=scan_dtype)
    out = (y * F.silu(z)) @ params["out_proj"]
    return out, dict(conv=conv_state, ssm=h_final)


def mamba_decode_step(params: Dict, x: torch.Tensor, cache: Dict, cfg
                      ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, D); cache: {conv: (B, K-1, Di), ssm: (B, Di, N)}."""
    Di = cfg.d_inner
    xz = gathered_product(x, params["in_proj"])
    u, z = torch.split(xz, [Di, Di], dim=-1)
    conv_in = torch.cat([cache["conv"], u], dim=1)               # (B, K, Di)
    w = params["conv_w"]
    uc = torch.einsum("bkd,kd->bd", conv_in.float(),
                      w.float()) + params["conv_b"]
    u1 = F.silu(uc)[:, None]                                      # (B,1,Di)
    delta, A, B_t, C_t = _ssm_projections(params, u1, cfg)
    a = torch.exp(delta[..., None] * A[None, None])[:, 0]         # (B,Di,N)
    b = ((delta * u1)[..., None] * B_t[:, :, None, :])[:, 0]
    h = a.float() * cache["ssm"] + b.float()
    y = torch.einsum("bdn,bn->bd", h, C_t[:, 0].float())
    y = (y[:, None] + u1.float() * params["D"][None, None]).to(x.dtype)
    out = (y * F.silu(z)) @ params["out_proj"]
    new_cache = dict(conv=conv_in[:, 1:], ssm=h)
    return out, new_cache
