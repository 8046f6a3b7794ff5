"""The MoE layer off a mesh, after its sharded lowering became the
reference partitioner's (``models/moe.py``: the router's logits whole on
each rank, each rank's own experts' slots gathered and combined, the
combine's result summed over the ranks), and the layer's timed parts.

Off a mesh ``moe_forward`` calls its functions directly.  Its output, aux
loss and the gradients of x, the router and the three expert weights are
held **bit for bit** to the plain path written out below: the layer as it
stood before the sharded lowering changed (router product, routing,
gather, optional e4m3 round trip, the three products, the bf16 scatter,
the aux loss), on reduced kimi-k2 and grok-1, float32 and bfloat16, with
either dispatch.  ``timed_parts`` reports each part of a forward.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, reduced
from repro_torch.models import moe as PMoE

ARCHS = ["kimi-k2-1t-a32b", "grok-1-314b"]
DISPATCH = ["bfloat16", "float8_e4m3fn"]
DTYPES = [torch.float32, torch.bfloat16]
NAMES = ("router", "wg", "wu", "wd")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(params, x, cfg):
    """``moe_forward`` off a mesh as it stood: (y, aux)."""
    G, S, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = PMoE.capacity(S, E, k, cfg.capacity_factor)
    logits = x @ params["router"].to(x.dtype)
    dispatch, gate, flat_expert, valid = PMoE._route_group(logits, k, C, E)
    token_idx = torch.where(valid, dispatch // k,
                            torch.full_like(dispatch, S))
    xpad = torch.cat([x, torch.zeros((G, 1, D), dtype=x.dtype)], dim=1)
    gidx = torch.arange(G)[:, None]
    xe = xpad[gidx, token_idx.reshape(G, E * C)].reshape(G, E, C, D)
    if cfg.moe_dispatch_dtype.startswith("float8"):
        xq, scale = PMoE.quantize_slots(xe)
        xe = PMoE.dequantize_slots(xq, scale, x.dtype)
    act = F.silu if cfg.mlp_act == "silu" else (
        lambda a: F.gelu(a, approximate="tanh"))
    xe_e = xe.permute(1, 0, 2, 3).reshape(E, G * C, D)
    g = xe_e @ params["wg"].to(x.dtype)
    u = xe_e @ params["wu"].to(x.dtype)
    ye = (act(g) * u) @ params["wd"].to(x.dtype)
    ye = ye.reshape(E, G, C, D).permute(1, 0, 2, 3)
    gate_flat = torch.cat([gate.reshape(G, S * k), torch.zeros((G, 1))],
                          dim=1)
    assign_gate = torch.gather(gate_flat, 1, torch.where(
        valid, dispatch, torch.full_like(dispatch, S * k)).reshape(
            G, E * C)).reshape(G, E, C)
    y = torch.zeros((G, S + 1, D), dtype=ye.dtype)
    y.index_put_((gidx[:, :, None].expand(G, E, C), token_idx),
                 ye * assign_gate[..., None].to(ye.dtype), accumulate=True)
    probs = torch.softmax(logits.float(), dim=-1)
    one_hot = F.one_hot(flat_expert.reshape(G, S, k)[..., 0], E).float()
    aux = E * torch.sum(probs.mean(dim=(0, 1))
                        * one_hot.reshape(-1, E).mean(dim=0))
    return y[:, :S], aux


def _case(arch, dispatch, dtype, seed=0):
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              moe_dispatch_dtype=dispatch)
    rng = np.random.default_rng(seed)
    D, E, F_ = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    w = dict(router=rng.standard_normal((D, E)) * D ** -0.5,
             wg=rng.standard_normal((E, D, F_)) * D ** -0.5,
             wu=rng.standard_normal((E, D, F_)) * D ** -0.5,
             wd=rng.standard_normal((E, F_, D)) * F_ ** -0.5)
    params = {n: torch.from_numpy(v.astype(np.float32)).to(dtype)
              for n, v in w.items()}
    x = torch.from_numpy(rng.standard_normal((3, 24, D)).astype(
        np.float32)).to(dtype)
    ct = torch.from_numpy(rng.standard_normal((3, 24, D)).astype(
        np.float32)).to(dtype)
    return cfg, params, x, ct


def _run(fn, cfg, params, x, ct):
    p = {n: t.clone().requires_grad_(True) for n, t in params.items()}
    xx = x.clone().requires_grad_(True)
    y, aux = fn(p, xx, cfg)[:2]
    grads = torch.autograd.grad((y * ct).float().sum() + aux,
                                [p[n] for n in NAMES] + [xx])
    return [y, aux, *grads]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", ARCHS)
def test_off_mesh_moe_forward_is_the_plain_path_bit_for_bit(arch, dispatch,
                                                            dtype):
    """Output, aux loss and the five gradients equal to the bit."""
    cfg, params, x, ct = _case(arch, dispatch, dtype)
    got = _run(PMoE.moe_forward, cfg, params, x, ct)
    want = _run(_plain, cfg, params, x, ct)
    for name, a, b in zip(("y", "aux") + NAMES + ("x",), got, want,
                          strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert got[0].abs().sum() > 0


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_timed_parts_report_each_part_of_a_forward(dispatch):
    """On the host, ``timed_parts`` gives each part's seconds, positive,
    the quantize and dequantize only with e4m3; the parts of two forwards
    add up; outside the block nothing is stamped."""
    cfg, params, x, _ = _case("kimi-k2-1t-a32b", dispatch, torch.float32)
    with torch.no_grad(), PMoE.timed_parts("cpu") as parts:
        PMoE.moe_forward(params, x, cfg)
    want = {"route", "exchange", "products", "combine"}
    if dispatch != "bfloat16":
        want |= {"quantize", "dequantize"}
    assert set(parts) == want and all(v > 0 for v in parts.values())
    with torch.no_grad(), PMoE.timed_parts("cpu") as twice:
        PMoE.moe_forward(params, x, cfg)
        PMoE.moe_forward(params, x, cfg)
    assert set(twice) == want
    assert PMoE._STAMP[0] is None
    PMoE.moe_forward(params, x, cfg)
