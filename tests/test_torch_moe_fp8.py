"""The float8 expert dispatch (``moe_dispatch_dtype="float8_e4m3fn"``)
against the JAX reference on the CPU, and its repairs around it.

Each slot crosses the expert-parallel boundary as e4m3 values and one
float32 scale (``models.moe.quantize_slots``).  Tolerances, each with its
reason:

* the payload, the scales and the dequantized slots: bit for bit against
  the reference's compiled quantize (XLA turns the division by 448 into a
  product with its reciprocal and fuses it with the ``+ 1e-12``; the port
  computes that fused result exactly);
* ``moe_forward`` in float32 (the reduced configs' dtype): output, aux
  loss and the gradients of x, router and experts within 1e-5 relative
  L2 (measured ~2.5e-7: the payload is the same, only the expert
  products' summation order differs); in bfloat16 the output within
  4 * 2^-8 (XLA keeps a fusion's bf16 intermediates in float32, torch
  rounds each op: a bf16 ulp in several of the four rounded results);
* a reduced kimi-k2 loss and every leaf's gradient: 1e-5 / 1e-4, as
  ``test_torch_train.py`` holds the bf16 dispatch;
* on 8 gloo ranks, the sharded fp8 train step against the single-device
  step: step 1 within 1e-6 (the mesh only reorders float32 sums; the
  quantize sees whole D rows on every rank); step 2 re-anchored (one
  device from the mesh's state after step 1) within 1e-6 where both sides
  round the dispatch's slots to the same e4m3 values, and without that
  only ties rounding otherwise; step 2 chained (from one device's own step
  1) within 1e-4: one float32 ulp moves step 2's loss by up to 1.05e-5
  through e4m3 payload elements that round to another value
  (``tools/fp8_step_noise.py``); ``ep_moe_forward`` on an fp8 config against
  the reference's within 1e-4 (``tests/test_torch_sharded.py``'s EP_TOL:
  the explicit-EP forward exchanges the compute dtype in both packages);
  the DTensor ``moe_forward`` with groups on every rank, whose dispatch
  all-to-all carries the e4m3 bytes, equal to one device's output.

Tests marked ``cuda`` quantize on the card against the host's bits; they
skip elsewhere.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_reference
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import model as PM
from repro_torch.models import moe as PMoE
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.ranks import (ep_moe_rank, moe_forward_rank,
                                        run_jobs, sharded_train_steps,
                                        train_batch, whole_leaves,
                                        with_host_staging)
from repro_torch.runtime import checkpoint as PCK
from repro_torch.train.steps import init_train_state, make_train_step
from test_torch_harness import ROOT, load_reference


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the one-device steps of the re-anchored check (the same config, batch
#: and optimizer as the sharded step's below)
REANCHORED = _tool("fp8_reanchored_step")

FP8 = "float8_e4m3fn"
ARCHS = ["kimi-k2-1t-a32b", "grok-1-314b"]
F32_REL = 1e-5
BF16_REL = 4 * 2.0 ** -8
LOSS_REL_TOL, GRAD_REL_TOL = 1e-5, 1e-4
#: the sharded step: B 8, S 32 on the (2, 4) mesh of tests/test_torch_sharded
B, S, MESH, RANKS, STEPS = 8, 32, (2, 4), 8, 2
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
SHARDED_TOL = 1e-6
#: step 2 chained (one device's own step 1 before it), where the float8
#: dispatch amplifies float32 rounding: one float32 ulp of random sign on
#: each element of step 1's gradient, as a reordered sum moves it, moved
#: step 2's loss (5.7106) by at most 1.05e-5 and its grad norm (3.44) by
#: at most 3.5e-5 (tools/fp8_step_noise.py, 4 draws a set: e4m3 payload
#: elements that round to another value; with the bf16 dispatch nothing
#: moves).  The bound is ~10 times the largest move the tool measured.
STEP2_TOL = 1e-4
#: the first dispatch's slots of step 2, one device's against the mesh's
#: from the same state: float32 ulps of the slot's largest magnitude
#: (reordered float32 sums ahead of the dispatch; measured at most 6.0
#: there, 8.5 in step 1's dispatches), the scales' ulps (7.0); a payload
#: element rounds otherwise only at a tie, its two quotients that many
#: ulps of 448 apart (measured: 2 elements, 0.45 ulp apart).
#: tools/fp8_reanchored_step.py
SLOT_ULPS = 16
LEAF_REL_TOL = 1e-4
EP_TOL = 1e-4
#: the DTensor forward's groups: 8, one a rank
EP_GROUPS = 8

#: the reference's EP forward and single-device MoE on an fp8 config (its
#: ep_moe_forward never reads moe_dispatch_dtype), as
#: tests/test_torch_sharded.py runs them: 8 XLA host devices
EP_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models.moe import moe_forward
from repro.parallel.ep_moe import ep_moe_forward

d = np.load(sys.argv[1])
params = {k: jnp.asarray(d[k]) for k in ("router", "wg", "wu", "wd")}
x = jnp.asarray(d["x"])
mesh = jax.make_mesh((2, 4), ("data", "model"))
xs = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
ps = dict(router=jax.device_put(params["router"], NamedSharding(mesh, P())),
          **{n: jax.device_put(params[n], NamedSharding(
              mesh, P("model", None, None))) for n in ("wg", "wu", "wd")})


class Cfg:
    d_model = 32; n_experts = 8; experts_per_token = 2; moe_d_ff = 16
    capacity_factor = 1.25; mlp_act = "silu"
    moe_dispatch_dtype = "float8_e4m3fn"


y_moe, _ = jax.jit(lambda p, x: moe_forward(p, x, Cfg))(params, x)
y_ep = ep_moe_forward(mesh, ps, xs, Cfg)
np.savez(sys.argv[2], y_moe=np.asarray(y_moe), y_ep=np.asarray(y_ep))
"""


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda")


def _fp8(cfg):
    return dataclasses.replace(cfg, moe_dispatch_dtype=FP8)


def _rel_l2(got, want) -> float:
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _np(t):
    return t.detach().float().numpy()


def _slots(seed: int, shape=(3, 4, 5, 64)) -> np.ndarray:
    """Slots of magnitudes spread over 2^-11 .. 2^11 a row, and one empty
    slot (zeros, as a capacity slot no token fills)."""
    rng = np.random.default_rng(seed)
    mag = np.exp2(rng.uniform(-11, 11, shape[:-1] + (1,)))
    x = (rng.standard_normal(shape) * mag).astype(np.float32)
    x[0, 0, 0] = 0
    return x


def _ref_quantize(ref, x):
    jnp = ref.jnp

    def q(xe):
        scale = jnp.max(jnp.abs(xe.astype(jnp.float32)), axis=-1,
                        keepdims=True) / 448.0 + 1e-12
        xq = (xe.astype(jnp.float32) / scale).astype(jnp.float8_e4m3fn)
        return xq, scale, (xq.astype(jnp.float32) * scale).astype(xe.dtype)

    return [np.asarray(a) for a in ref.jax.jit(q)(x)]


# --------------------------------------------------------------------------
# the quantize
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_is_the_references_bit_for_bit(ref, dtype):
    """Payload bits, scale bits and the dequantized slots equal the
    reference's compiled quantize (``moe.py:93-104`` in a jit), for slots
    of every magnitude and an empty slot (payload 0, scale 1e-12)."""
    jnp = ref.jnp
    x = _slots(0)
    xj = jnp.asarray(x).astype(dtype)
    q_r, s_r, d_r = _ref_quantize(ref, xj)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    q, s = PMoE.quantize_slots(xt)
    d = PMoE.dequantize_slots(q, s, xt.dtype)
    assert q.dtype == torch.float8_e4m3fn and s.dtype == torch.float32
    assert tuple(s.shape) == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  q_r.view(np.uint8))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  s_r.view(np.uint32))
    np.testing.assert_array_equal(_np(d), np.asarray(d_r, np.float32))
    assert float(s[0, 0, 0]) == np.float32(1e-12)
    assert not q[0, 0, 0].float().any()
    assert float(q.float().abs().max()) <= PMoE.E4M3_MAX


def test_quantize_gradient_goes_through_e4m3_as_jax_does(ref):
    """JAX's VJP of the cast to e4m3 casts the cotangent to e4m3 too: a
    cotangent of 1e-4 (under half e4m3's smallest subnormal, 2^-9) is 0,
    and so it does through torch's autograd of the same casts; the
    quantize's gradient equals ``jax.grad`` of the reference's."""
    jax, jnp = ref.jax, ref.jnp
    a = np.linspace(-3, 3, 17).astype(np.float32)
    g_ref = jax.grad(lambda v: jnp.sum(
        v.astype(jnp.float8_e4m3fn).astype(jnp.float32) * 1e-4))(a)
    t = torch.from_numpy(a).requires_grad_(True)
    (t.to(torch.float8_e4m3fn).float() * 1e-4).sum().backward()
    assert not np.asarray(g_ref).any() and not t.grad.any()
    # the whole quantize-dequantize, cotangent drawn at scale
    x = _slots(1, (2, 3, 4, 32))
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def rq(xe):
        scale = jnp.max(jnp.abs(xe), axis=-1, keepdims=True) / 448.0 + 1e-12
        xq = (xe / scale).astype(jnp.float8_e4m3fn)
        return jnp.sum((xq.astype(jnp.float32) * scale) * w)

    g_ref = np.asarray(jax.jit(jax.grad(rq))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    q, s = PMoE.quantize_slots(t)
    (PMoE.dequantize_slots(q, s, torch.float32) * torch.from_numpy(w)).sum(
    ).backward()
    assert g_ref.any()
    assert _rel_l2(_np(t.grad), g_ref) <= F32_REL


# --------------------------------------------------------------------------
# moe_forward and the train step against the reference
# --------------------------------------------------------------------------

def _moe_case(ref, arch, seed=0):
    """The reduced config with the fp8 dispatch in both packages, the
    layer's weights drawn from a numpy seed, x (3, 24, D) and a cotangent."""
    cfg = _fp8(reduced(get_config(arch)))
    rcfg = _fp8(ref.config_base.reduced(ref.configs.get_config(arch)))
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    w = dict(router=rng.standard_normal((D, E)) * D ** -0.5,
             wg=rng.standard_normal((E, D, F)) * D ** -0.5,
             wu=rng.standard_normal((E, D, F)) * D ** -0.5,
             wd=rng.standard_normal((E, F, D)) * F ** -0.5,
             norm=np.ones(D))
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((3, 24, D)).astype(np.float32)
    ct = rng.standard_normal((3, 24, D)).astype(np.float32)
    return cfg, rcfg, w, x, ct


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_and_gradients_match_the_reference(ref, arch):
    """Reduced kimi-k2 and grok-1 with the fp8 dispatch, float32: the
    output and aux loss, and the gradients of ``sum(y * ct) + aux`` with
    respect to x, the router and the three expert weights, against
    ``jax.value_and_grad`` of the reference's (compiled); the fp8 output
    differs from the bf16 dispatch's, in both packages alike."""
    jax, jnp = ref.jax, ref.jnp
    cfg, rcfg, w, x, ct = _moe_case(ref, arch)
    names = ("router", "wg", "wu", "wd")

    def rf(p, xx):
        y, aux = ref.moe.moe_forward(p, xx, rcfg)
        return jnp.sum(y * ct) + aux, (y, aux)

    (_, (y_r, aux_r)), (g_p, g_x) = jax.jit(jax.value_and_grad(
        rf, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = PMoE.moe_forward(tp, tx, cfg)
    grads = torch.autograd.grad((y * torch.from_numpy(ct)).sum() + aux,
                                [tp[n] for n in names] + [tx])
    assert _rel_l2(_np(y), y_r) <= F32_REL
    np.testing.assert_allclose(float(aux.detach()), float(aux_r),
                               rtol=F32_REL)
    for n, g, want in zip(names + ("x",), grads,
                          [g_p[n] for n in names] + [g_x], strict=True):
        assert np.asarray(want).any(), n
        assert _rel_l2(_np(g), want) <= F32_REL, (n, _rel_l2(_np(g), want))
    # the payload really is e4m3: against the bf16 dispatch, both packages
    y16, _ = PMoE.moe_forward(
        {k: v.detach() for k, v in tp.items()}, tx.detach(),
        dataclasses.replace(cfg, moe_dispatch_dtype="bfloat16"))
    gap = _rel_l2(_np(y), _np(y16))
    assert 1e-3 < gap < 0.1, gap
    y16_r, _ = ref.moe.moe_forward(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
        dataclasses.replace(rcfg, moe_dispatch_dtype="bfloat16"))
    np.testing.assert_allclose(gap, _rel_l2(y_r, y16_r), rtol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_in_bfloat16_matches_the_reference(ref, arch):
    """The same layer with x in bfloat16 (the published configs' compute
    dtype): the output within 4 bf16 ulps relative L2 of the reference's,
    the aux loss within 1e-5."""
    jax, jnp = ref.jax, ref.jnp
    cfg, rcfg, w, x, _ = _moe_case(ref, arch, seed=3)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    y_r, aux_r = jax.jit(lambda p, xx: ref.moe.moe_forward(p, xx, rcfg))(
        {k: jnp.asarray(v) for k, v in w.items()}, xb)
    tx = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16)
    y, aux = PMoE.moe_forward({k: torch.from_numpy(v) for k, v in w.items()},
                              tx, cfg)
    assert y.dtype == torch.bfloat16
    assert _rel_l2(_np(y), np.asarray(y_r, np.float32)) <= BF16_REL
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=F32_REL)


@pytest.mark.parametrize("dtype", ["bfloat16", FP8])
def test_moe_forward_returns_the_dispatch_it_routed_by(ref, dtype):
    """``return_dispatch`` adds the (G, E, C) table the forward routed by:
    each group's the reference's ``_route_group`` of the same logits, with
    either dispatch dtype; y and the aux loss are those of the plain
    call, bit for bit."""
    jax, jnp = ref.jax, ref.jnp
    cfg, _, w, x, _ = _moe_case(ref, "kimi-k2-1t-a32b", seed=5)
    cfg = dataclasses.replace(cfg, moe_dispatch_dtype=dtype)
    tp = {k: torch.from_numpy(v) for k, v in w.items()}
    y, aux, dispatch = PMoE.moe_forward(tp, torch.from_numpy(x), cfg,
                                        return_dispatch=True)
    y0, aux0 = PMoE.moe_forward(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(_np(y), _np(y0))
    assert float(aux) == float(aux0)
    E, k = cfg.n_experts, cfg.experts_per_token
    C = PMoE.capacity(x.shape[1], E, k, cfg.capacity_factor)
    assert dispatch.shape == (x.shape[0], E, C)
    for g in range(x.shape[0]):
        want = ref.moe._route_group(jnp.asarray(x[g]),
                                    jnp.asarray(x[g] @ w["router"]), k, C,
                                    E)[0]
        np.testing.assert_array_equal(dispatch[g].numpy(), np.asarray(want))


def test_train_loss_and_gradients_match_the_reference(ref):
    """Reduced kimi-k2 with the fp8 dispatch: ``loss_fn`` and the gradient
    of every parameter leaf against the reference's compiled
    ``jax.value_and_grad(loss_fn)`` on the same weights (its own init) and
    batch; the port's train step reports the same loss."""
    jax = ref.jax
    arch = "kimi-k2-1t-a32b"
    rcfg = _fp8(ref.config_base.reduced(ref.configs.get_config(arch)))
    rp = ref.model.init_params(rcfg, jax.random.PRNGKey(0))
    cfg = _fp8(reduced(get_config(arch)))
    p = params_from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    labels[0, :5] = -1
    rb = {"tokens": ref.jnp.asarray(toks), "labels": ref.jnp.asarray(labels)}
    pb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    (rl, rm), rg = jax.jit(jax.value_and_grad(
        lambda pp, bb: ref.model.loss_fn(pp, bb, rcfg), has_aux=True))(rp, rb)
    flat, _ = T.flatten(p)
    for t in flat:
        t.requires_grad_(True)
    loss, metrics = PM.loss_fn(p, pb, cfg)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    assert abs(float(loss) / float(rl) - 1) <= LOSS_REL_TOL
    np.testing.assert_allclose(float(metrics["aux"]), float(rm["aux"]),
                               rtol=1e-5, atol=1e-7)
    rleaves = jax.tree.leaves(rg)
    assert len(rleaves) == len(grads)
    for i, (g, want) in enumerate(zip(grads, rleaves)):
        assert tuple(g.shape) == tuple(want.shape), i
        assert _rel_l2(_np(g), want) <= GRAD_REL_TOL, (i, _rel_l2(_np(g),
                                                                  want))
    for t in flat:
        t.requires_grad_(False)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = init_train_state(cfg, opt, seed=0, device="cpu")[1]
    _, _, m = make_train_step(cfg, opt)(p, state, pb)
    assert abs(float(m["loss"]) / float(rm["loss"]) - 1) <= LOSS_REL_TOL


# --------------------------------------------------------------------------
# on 8 gloo ranks: the sharded step, ep_moe_forward, the DTensor dispatch
# --------------------------------------------------------------------------

def _ep_inputs(G: int):
    rng = np.random.default_rng(0)
    f32 = np.float32
    return dict(router=(rng.standard_normal((32, 8)) * 0.1).astype(f32),
                wg=(rng.standard_normal((8, 32, 16)) * 0.1).astype(f32),
                wu=(rng.standard_normal((8, 32, 16)) * 0.1).astype(f32),
                wd=(rng.standard_normal((8, 16, 32)) * 0.1).astype(f32),
                x=rng.standard_normal((G, 24, 32)).astype(f32))


def _ep_cfg():
    return types.SimpleNamespace(
        d_model=32, n_experts=8, experts_per_token=2, moe_d_ff=16,
        capacity_factor=1.25, mlp_act="silu", moe_dispatch_dtype=FP8)


def _dispatch_cfg():
    """A reduced kimi-k2 layer at the EP inputs' widths (dataclass, so the
    rank can switch its dispatch dtype)."""
    return dataclasses.replace(
        _fp8(reduced(get_config("kimi-k2-1t-a32b"))), d_model=32,
        n_experts=8, experts_per_token=2, moe_d_ff=16, capacity_factor=1.25)


def _sharded_fp8_steps(rank: int, world: int) -> list:
    """A rank of the sharded fp8 train steps: ``sharded_train_steps`` with
    each step's state returned whole, and on rank 0 also each step's
    dispatch slots (``quantize_slots``' input, whole, in call order)."""
    slots = []
    quantize, PMoE.quantize_slots = REANCHORED.recording_quantize(slots)
    try:
        rows = sharded_train_steps(
            rank, world, [_fp8(reduced(get_config("kimi-k2-1t-a32b")))],
            OPT, B, S, MESH, "cpu", steps=STEPS, leaves=None, states=True)
    finally:
        PMoE.quantize_slots = quantize
    n = len(slots) // STEPS
    assert n * STEPS == len(slots), len(slots)
    if rank == 0:
        rows[0]["slots"] = [slots[k * n:(k + 1) * n] for k in range(STEPS)]
    return rows


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's EP forward in its subprocess, left running while one
    launch of eight ranks runs the sharded fp8 train step, the fp8
    ``ep_moe_forward`` and the DTensor ``moe_forward`` (unstaged, then
    staged through the host as ranks sharing a card run it)."""
    tmp = tmp_path_factory.mktemp("ep_fp8_ref")
    ep = _ep_inputs(4)
    np.savez(tmp / "in.npz", **ep)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", EP_REF,
                             str(tmp / "in.npz"), str(tmp / "out.npz")],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        dts = ("bfloat16", FP8)
        wide = _ep_inputs(EP_GROUPS)
        jobs = [(_sharded_fp8_steps, ()),
                (ep_moe_rank, (ep, _ep_cfg(), MESH, "cpu")),
                (moe_forward_rank, (wide, _dispatch_cfg(), MESH, "cpu", dts)),
                (with_host_staging, ("cpu", moe_forward_rank,
                                     (wide, _dispatch_cfg(), MESH, "cpu",
                                      dts)))]
        ranks = run_ranks(run_jobs, RANKS, jobs, device="cpu")
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return ranks, dict(np.load(tmp / "out.npz"))


def _held(got: dict, want: dict, tol: float) -> None:
    """A step's loss within ``tol`` of ``want``'s, its grad norm within
    ``tol`` relative (absolute below 1)."""
    assert abs(got["loss"] - want["loss"]) < tol, (got, want)
    assert abs(got["grad_norm"] - want["grad_norm"]) < tol * max(
        want["grad_norm"], 1), (got, want)


def test_sharded_fp8_train_step_matches_single_device(runs):
    """Reduced kimi-k2 with the fp8 dispatch on the (2, 4) mesh, two steps.

    Step 1, from the same initial state: loss and grad norm within
    SHARDED_TOL of the single-device step, every leaf's gradient within
    LEAF_REL_TOL relative L2 (the mesh only reorders float32 sums; the
    quantize sees whole D rows on every rank).

    Step 2 re-anchored: one device runs it from the mesh's own parameters
    and optimizer state after step 1 (the ranks return them whole).  Both
    sides then start from the same bits and only the step's own float32
    order differs, as in step 1; but at a tie a reordered sum rounds a
    payload element to the next e4m3 value, and that moves the loss by
    ~1e-5 (measured: 2 of the first dispatch's 131,072 elements, 9.1e-6
    on the loss).  So: one device's first dispatch slots equal the mesh's
    to SLOT_ULPS float32 ulps, with every payload element that rounds
    otherwise a tie; and with each dispatch's payload and scales taken
    from the mesh's slots, the loss and grad norm within SHARDED_TOL
    (``tools/fp8_reanchored_step.py`` runs the one-device steps and
    prints the same readings).

    Step 2 chained, from one device's own step 1: within STEP2_TOL (its
    derivation beside the constant)."""
    ranks, _ = runs
    assert (REANCHORED.B, REANCHORED.S, REANCHORED.OPT) == (B, S, OPT)
    cfg = _fp8(reduced(get_config("kimi-k2-1t-a32b")))
    params, opt = init_train_state(cfg, OPT, seed=0, device="cpu")
    grads = []
    step = make_train_step(cfg, OPT, on_grads=lambda g: grads.append(
        whole_leaves(g)))
    chained = []
    for k in range(STEPS):
        params, opt, m = step(params, opt, train_batch(cfg, B, S, "cpu", k))
        chained.append({n: float(v) for n, v in m.items()})
    rows = [r[0][0] for r in ranks]
    for r in rows:
        assert r["metrics"] == rows[0]["metrics"]
    got = rows[0]["metrics"]
    assert len(got) == STEPS == 2
    _held(got[0], chained[0], SHARDED_TOL)
    mine, single = rows[0]["grads"][0], grads[0]
    assert sorted(mine) == sorted(single)
    worst = max((_rel_l2(mine[j], single[j]), j) for j in single)
    assert worst[0] < LEAF_REL_TOL, worst
    state, on_mesh = rows[0]["states"][0], rows[0]["slots"][1]
    _, own = REANCHORED.one_device_step(cfg, 1, state)
    assert len(own) == len(on_mesh)
    first = REANCHORED.dispatch_change(own[0], on_mesh[0])
    assert first["slot_ulps_max"] <= SLOT_ULPS, first
    assert first["scale_ulps_max"] <= SLOT_ULPS, first
    assert (first["tie_distance_ulps_of_448"] or 0) <= SLOT_ULPS, first
    shared, _ = REANCHORED.one_device_step(cfg, 1, state, on_mesh)
    _held(got[1], shared, SHARDED_TOL)
    _held(got[1], chained[1], STEP2_TOL)


def test_ep_moe_forward_on_an_fp8_config_is_the_references(runs):
    """``ep_moe_forward`` no longer refuses the fp8 config: on the (2, 4)
    mesh it returns the reference's ``ep_moe_forward`` on the same config,
    two exchanges of the rank's padded slots in the compute dtype."""
    ranks, want = runs
    rows = [r[1] for r in ranks]
    C = PMoE.capacity(24, 8, 2, 1.25)
    for r in rows:
        assert r["all_to_all"] == 2
        assert r["all_to_all_bytes"] == 2 * (4 // MESH[0]) * 8 * C * 32 * 4
    assert np.abs(rows[0]["y"] - want["y_ep"]).max() < EP_TOL


@pytest.mark.parametrize("staged", [False, True])
def test_dtensor_fp8_dispatch_equals_one_device(runs, staged):
    """The DTensor ``moe_forward`` with one group a rank: its dispatch
    all-to-all carries the e4m3 bytes (as uint8: gloo has no float8), and
    the output equals the single-device forward's to the bit, bf16 and
    fp8 dispatch alike; the dispatch tables are equal; staged through the
    host, the fp8 forward copies fewer bytes than the compute-dtype one."""
    ranks, _ = runs
    row = ranks[0][3][0] if staged else ranks[0][2]
    inp = _ep_inputs(EP_GROUPS)
    tp = {k: torch.from_numpy(v) for k, v in inp.items()}
    x = tp.pop("x")
    cfg = _dispatch_cfg()
    for dt in ("bfloat16", FP8):
        y, _ = PMoE.moe_forward(tp, x, dataclasses.replace(
            cfg, moe_dispatch_dtype=dt))
        np.testing.assert_array_equal(row[dt]["y"], _np(y))
    C = row["capacity"]
    want = PMoE._route_group(x @ tp["router"], 2, C, 8)[0].numpy()
    for dt in ("bfloat16", FP8):
        np.testing.assert_array_equal(row[dt]["dispatch"], want)
    if staged:
        moved = {dt: row[dt]["staged"]["bytes"] for dt in ("bfloat16", FP8)}
        assert 0 < moved[FP8] < moved["bfloat16"], moved


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def test_float8_leaves_round_trip_bit_for_bit(tmp_path):
    """float8 leaves (e4m3 and e5m2, every bit pattern but NaN) are stored
    as float32, named by their dtype in the manifest, and restored bit for
    bit."""
    import json

    bits = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    state = {}
    for name, dt in (("e4m3", torch.float8_e4m3fn), ("e5m2",
                                                    torch.float8_e5m2)):
        v = bits.view(dt)
        state[name] = v[~torch.isnan(v.float())]
    state["w"] = torch.ones(3, dtype=torch.bfloat16)
    PCK.save_checkpoint(str(tmp_path), 1, state)
    like = {k: torch.zeros_like(v) for k, v in state.items()}
    got, step = PCK.restore_checkpoint(str(tmp_path), like)
    assert step == 1
    for k in state:
        assert got[k].dtype == state[k].dtype
        if k != "w":
            np.testing.assert_array_equal(got[k].view(torch.uint8).numpy(),
                                          state[k].view(torch.uint8).numpy())
    manifest = json.loads((tmp_path / "step_000000001" / "manifest.json")
                          .read_text())
    assert manifest["dtypes"] == ["float8_e4m3fn", "float8_e5m2", "bfloat16"]


def test_a_reference_float8_checkpoint_restores_in_the_port(ref, tmp_path):
    """A checkpoint the reference writes with a float8 leaf (stored as
    float32) restores in the port bit for bit, and the port's restores in
    the reference."""
    jnp = ref.jnp
    vals = np.linspace(-448, 448, 33).astype(np.float32)
    rstate = {"q": jnp.asarray(vals).astype(jnp.float8_e4m3fn),
              "s": jnp.asarray(vals[:4])}
    ref.checkpoint.save_checkpoint(str(tmp_path / "r"), 2, rstate)
    like = {"q": torch.zeros(33, dtype=torch.float8_e4m3fn),
            "s": torch.zeros(4)}
    got, step = PCK.restore_checkpoint(str(tmp_path / "r"), like)
    assert step == 2 and got["q"].dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(got["q"].view(torch.uint8).numpy(),
                                  np.asarray(rstate["q"]).view(np.uint8))
    PCK.save_checkpoint(str(tmp_path / "p"), 2, got)
    back, _ = ref.checkpoint.restore_checkpoint(
        str(tmp_path / "p"), ref.jax.tree.map(jnp.zeros_like, rstate))
    assert back["q"].dtype == jnp.float8_e4m3fn
    np.testing.assert_array_equal(np.asarray(back["q"]).view(np.uint8),
                                  np.asarray(rstate["q"]).view(np.uint8))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_on_the_card_is_the_hosts(cuda_device, dtype):
    """The card's quantize of the same slots: payload, scale and
    dequantized bits equal to the host's."""
    x = torch.from_numpy(_slots(4, (4, 384, 27, 7168 // 8))).to(dtype)
    q_h, s_h = PMoE.quantize_slots(x)
    q_d, s_d = PMoE.quantize_slots(x.to(cuda_device))
    assert torch.equal(q_d.cpu().view(torch.uint8), q_h.view(torch.uint8))
    assert torch.equal(s_d.cpu().view(torch.int32), s_h.view(torch.int32))
    d_h = PMoE.dequantize_slots(q_h, s_h, dtype)
    d_d = PMoE.dequantize_slots(q_d, s_d, dtype)
    assert torch.equal(d_d.cpu(), d_h)


@pytest.mark.cuda
def test_fp8_moe_forward_on_the_card_is_close_to_the_host(cuda_device):
    """Reduced kimi-k2's MoE layer with the fp8 dispatch, float32, on the
    card against the host: within 1e-5 relative L2 (cuBLAS and the CPU sum
    in other orders)."""
    cfg = _fp8(reduced(get_config("kimi-k2-1t-a32b")))
    rng = np.random.default_rng(5)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    w = {k: torch.from_numpy((rng.standard_normal(s) * 0.2).astype(
        np.float32)) for k, s in (("router", (D, E)), ("wg", (E, D, F)),
                                  ("wu", (E, D, F)), ("wd", (E, F, D)))}
    x = torch.from_numpy(rng.standard_normal((3, 24, D)).astype(np.float32))
    y_h, _ = PMoE.moe_forward(w, x, cfg)
    y_d, _ = PMoE.moe_forward({k: v.to(cuda_device) for k, v in w.items()},
                              x.to(cuda_device), cfg)
    assert _rel_l2(_np(y_d.cpu()), _np(y_h)) <= F32_REL
