"""The port's training half against the JAX reference, on the CPU: the
chunked loss and its gradient, remat, the AdamW schedule and update, int8
gradient compression, the train / prefill / decode step functions and the
synthetic data pipeline.

Inputs are numpy draws from a seed; model weights are the reference's own
``init_params`` carried into the port with ``params_from_reference``, in
f32.  Tolerances, each with its reason:

* ``loss_fn``: loss to 1e-5 relative and every leaf's gradient to 1e-4
  relative L2 (f32; the two frameworks sum in other orders);
* ``cosine_schedule``: 1e-6 relative -- XLA's f32 ``cos`` and torch's
  differ by up to one ulp of 1 (6e-8), which the schedule scales by 0.45
  and sets against its 0.1 floor near the end of the decay (<= 3e-7);
* ``adamw_update``: lr and grad norm to 1e-6 relative (summation order);
  m and v to 2e-6 relative (XLA contracts ``m * b1 + (1 - b1) * g`` into a
  fused multiply-add, torch rounds twice: an ulp or two), bf16 state to one
  bf16 ulp; parameters to 1e-4 * lr absolute on drawn gradients, and to
  ``PARAM_LR_TOL`` * lr after a model's train step, since m-hat /
  (sqrt(v-hat) + eps) turns the rounding of a near-zero gradient entry into
  a step of up to lr; bf16 parameters to one bf16 ulp;
* ``compress`` / ``apply_error_feedback`` and ``synthetic_batch``: bit for
  bit.
"""
import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import get_config, reduced
from repro_torch.data import pipeline as PD
from repro_torch.interop import params_from_reference
from repro_torch.models import model as PM
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as PA
from repro_torch.optim import compression as PC
from repro_torch.train import steps as PS
from test_torch_harness import load_reference

LOSS_REL_TOL = 1e-5
GRAD_REL_TOL = 1e-4
BF16_ULP = 2.0 ** -8
#: parameters after a model's train step, in units of lr: Adam's first step
#: is lr * g / (|g| + 1e-8), so an entry whose gradient is within a few eps
#: of zero steps by a fraction of lr that follows its rounding; on the
#: reduced qwen2-7b the largest such gap is 1.3 % of lr (the key bias, whose
#: gradient is small), every other leaf's under 0.2 %
PARAM_LR_TOL = 0.05


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the JAX reference and other pytest workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(x, np.float32).astype(np.float64)


def _rel_l2(got, want) -> float:
    g, w = _np32(got), _np32(want)
    den = np.linalg.norm(w)
    return float(np.linalg.norm(g - w) / den) if den else float(
        np.linalg.norm(g))


def _ref_model(ref, arch, seed=0):
    rcfg = ref.config_base.reduced(ref.configs.get_config(arch))
    rp = ref.model.init_params(rcfg, ref.jax.random.PRNGKey(seed))
    cfg = reduced(get_config(arch))
    p = params_from_reference(ref.jax.tree.map(np.asarray, rp), cfg, "cpu")
    return rcfg, rp, cfg, p


def _batches(ref, cfg, B, S, seed):
    """The same batch for both packages: tokens (or stub embeddings) and
    labels, with the first 5 labels of row 0 set to -1 (no label)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :5] = -1
    if cfg.frontend != "none":
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        key = "embeds"
    else:
        x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        key = "tokens"
    jnp = ref.jnp
    return ({key: jnp.asarray(x), "labels": jnp.asarray(labels)},
            {key: torch.as_tensor(x), "labels": torch.as_tensor(labels)})


def _port_grads(p, batch, cfg):
    flat, treedef = T.flatten(p)
    for x in flat:
        x.requires_grad_(True)
    loss, metrics = PM.loss_fn(p, batch, cfg)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    for x in flat:
        x.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


# --------------------------------------------------------------------------
# loss_fn and its gradient
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-7b", "jamba-v0.1-52b",
                                  "falcon-mamba-7b", "hubert-xlarge"])
def test_loss_and_gradient_match_reference(ref, arch):
    """``loss_fn`` and the gradient of every parameter leaf against
    ``jax.value_and_grad(M.loss_fn)`` on the reduced configs of the
    reference's ``test_smoke_train_step`` (hubert: stub embeddings,
    non-causal); S = 21 is no multiple of the loss chunk (16), and five
    labels are -1."""
    rcfg, rp, cfg, p = _ref_model(ref, arch)
    rb, pb = _batches(ref, cfg, 2, 21, seed=1)
    (rl, rm), rg = ref.jax.value_and_grad(ref.model.loss_fn, has_aux=True)(
        rp, rb, rcfg)
    loss, metrics, grads = _port_grads(p, pb, cfg)
    assert abs(float(loss) / float(rl) - 1) <= LOSS_REL_TOL
    assert abs(float(metrics["loss"]) / float(rm["loss"]) - 1) <= LOSS_REL_TOL
    assert int(metrics["tokens"]) == int(rm["tokens"]) == 2 * 21 - 5
    np.testing.assert_allclose(float(metrics["aux"]), float(rm["aux"]),
                               rtol=1e-5, atol=1e-7)
    rleaves = ref.jax.tree.leaves(rg)
    assert len(rleaves) == len(grads)
    for i, (g, w) in enumerate(zip(grads, rleaves)):
        assert tuple(g.shape) == tuple(w.shape), i
        assert _rel_l2(g, w) <= GRAD_REL_TOL, (i, _rel_l2(g, w))


def test_loss_near_log_vocab_at_init_and_no_labels():
    """The reference's smoke criterion on the port's own init, and a batch
    without a single label: loss 0 over max(count, 1)."""
    cfg = reduced(get_config("qwen2-7b"))
    p = PM.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 32)))
    with torch.no_grad():
        _, m = PM.loss_fn(p, {"tokens": toks, "labels": toks}, cfg)
        assert abs(float(m["loss"]) - np.log(cfg.vocab_size)) < 2.0
        total, m = PM.loss_fn(p, {"tokens": toks,
                                  "labels": torch.full_like(toks, -1)}, cfg)
    assert float(m["loss"]) == 0.0 and int(m["tokens"]) == 0
    assert float(total) == float(cfg.router_aux_coef * m["aux"])


def test_remat_does_not_change_the_numbers(monkeypatch):
    """remat=True recomputes every repeat of the pattern and every loss
    chunk in the backward (each body runs twice) and gives the same loss
    and gradients as remat=False, bit for bit (the recompute repeats the
    same CPU arithmetic); reduced jamba: attention, Mamba, MoE."""
    import dataclasses

    calls = {"block": 0, "chunk": 0}
    one_block, chunk = PT._one_block, PM._chunk_nll

    def counted_block(*a, **k):
        calls["block"] += 1
        return one_block(*a, **k)

    def counted_chunk(*a, **k):
        calls["chunk"] += 1
        return chunk(*a, **k)

    monkeypatch.setattr(PT, "_one_block", counted_block)
    monkeypatch.setattr(PM, "_chunk_nll", counted_chunk)
    base = reduced(get_config("jamba-v0.1-52b"))
    p = PM.init_params(base, seed=4, device="cpu")
    rng = np.random.default_rng(4)
    toks = torch.as_tensor(rng.integers(0, base.vocab_size, (2, 40)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        calls.update(block=0, chunk=0)
        out[remat] = _port_grads(p, batch, cfg)
        n_chunks = -(-40 // cfg.loss_chunk)
        assert calls == {"block": cfg.n_layers * (1 + remat),
                         "chunk": n_chunks * (1 + remat)}, (remat, calls)
    (l0, _, g0), (l1, _, g1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

@pytest.mark.parametrize("opt", [dict(), dict(lr=1e-3, warmup_steps=3,
                                              total_steps=11, min_lr_frac=0.2)])
def test_cosine_schedule_matches_reference(ref, opt):
    rc, pc = ref.adamw.AdamWConfig(**opt), PA.AdamWConfig(**opt)
    n = pc.total_steps
    steps = list(range(0, 130)) + list(range(n - 130, n + 6)) \
        if n > 300 else list(range(0, n + 6))
    jitted = ref.jax.jit(lambda s: ref.adamw.cosine_schedule(rc, s))
    for s in steps:
        got = PA.cosine_schedule(pc, torch.tensor(float(s)))
        assert got.dtype == torch.float32 and got.dim() == 0
        for want in (ref.adamw.cosine_schedule(rc, ref.jnp.float32(s)),
                     jitted(ref.jnp.float32(s))):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       atol=0, err_msg=str(s))


def _opt_trees(seed):
    """A parameter-like tree with (R, D) stacked leaves, an (R, D, F)
    stack, 2-D leaves, a 1-D leaf and bf16 leaves, and a gradient tree of
    the same structure and dtypes."""
    rng = np.random.default_rng(seed)

    def draw(shape, scale=1.0, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    p = dict(blocks=[dict(norm1=draw((2, 8), 0.1, 1.0), w=draw((2, 8, 6)),
                          b=draw((2, 6), 0.1))],
             embed=draw((11, 8)), final_norm=draw((8,), 0.1, 1.0),
             head=draw((8, 11)))
    g = T.tree_map(lambda x: draw(x.shape, 0.3), p)
    g["blocks"][0]["w"][0, 0, :3] = 0.0           # zero entries: m-hat / eps
    return p, g


def _as_bf16(ref, tree, names):
    """numpy tree with the named top-level leaves as bf16 numpy arrays."""
    out = dict(tree)
    for n in names:
        out[n] = np.asarray(ref.jnp.asarray(tree[n]).astype(ref.jnp.bfloat16))
    return out


def _to_torch(tree):
    from repro_torch.interop import _tensor_from_numpy
    return T.tree_map(lambda a: _tensor_from_numpy(a, torch.device("cpu")),
                      tree)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_clip_and_adamw_update_match_reference(ref, state_dtype):
    """``clip_by_global_norm`` and three ``adamw_update`` steps on a tree
    with bf16 leaves, (R, D) stacked leaves (decayed) and a 1-D leaf (not
    decayed), clip active."""
    jax, jnp = ref.jax, ref.jnp
    p_np, g_np = _opt_trees(5)
    p_np, g_np = (_as_bf16(ref, t, ("head",)) for t in (p_np, g_np))
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5,
               state_dtype=state_dtype)
    rc, pc = ref.adamw.AdamWConfig(**opt), PA.AdamWConfig(**opt)
    rp, rg = (jax.tree.map(jnp.asarray, t) for t in (p_np, g_np))
    pp, pg = _to_torch(p_np), _to_torch(g_np)

    clipped, gn = PA.clip_by_global_norm(pg, pc.clip_norm)
    rclipped, rgn = ref.adamw.clip_by_global_norm(rg, rc.clip_norm)
    np.testing.assert_allclose(float(gn), float(rgn), rtol=1e-6)
    assert float(gn) > pc.clip_norm                 # the clip is active
    for a, b in zip(T.leaves(clipped), jax.tree.leaves(rclipped)):
        assert str(a.dtype).endswith(str(b.dtype))
        tol = BF16_ULP if b.dtype == jnp.bfloat16 else 1e-6
        np.testing.assert_allclose(_np32(a), _np32(b), rtol=tol, atol=1e-7)

    rs, ps = ref.adamw.adamw_init(rp, rc), PA.adamw_init(pp, pc)
    assert ps["step"].dtype == torch.int32 and ps["step"].dim() == 0
    for _ in range(3):
        rp, rs, rm = ref.adamw.adamw_update(rp, rg, rs, rc)
        pp, ps, pm = PA.adamw_update(pp, pg, ps, pc)
        lr = float(rm["lr"])
        np.testing.assert_allclose(float(pm["lr"]), lr, rtol=1e-6)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        assert int(ps["step"]) == int(rs["step"])
        for a, b in zip(T.leaves(pp), jax.tree.leaves(rp)):
            assert str(a.dtype).endswith(str(b.dtype))
            if b.dtype == jnp.bfloat16:
                np.testing.assert_allclose(_np32(a), _np32(b), rtol=BF16_ULP)
            else:
                np.testing.assert_allclose(_np32(a), _np32(b), rtol=0,
                                           atol=1e-4 * lr)
        for key in ("m", "v"):
            for a, b in zip(T.leaves(ps[key]), jax.tree.leaves(rs[key])):
                assert str(a.dtype).endswith(state_dtype)
                tol = BF16_ULP if state_dtype == "bfloat16" else 2e-6
                np.testing.assert_allclose(_np32(a), _np32(b), rtol=tol,
                                           atol=1e-12)
    # the 1-D leaf is not decayed, the stacked (R, D) norm is
    assert "final_norm" in pp and pp["blocks"][0]["norm1"].dim() == 2


def test_adamw_update_works_in_place_in_slices(monkeypatch):
    """The update writes into the given tensors, and the slice size changes
    no number (every operation is elementwise)."""
    p_np, g_np = _opt_trees(6)
    cfg = PA.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    whole = _to_torch(p_np)
    sw = PA.adamw_init(whole, cfg)
    PA.adamw_update(whole, _to_torch(g_np), sw, cfg)
    monkeypatch.setattr(PA, "_CHUNK", 7)
    sliced = _to_torch(p_np)
    ids = [id(t) for t in T.leaves(sliced)]
    ss = PA.adamw_init(sliced, cfg)
    out, st, _ = PA.adamw_update(sliced, _to_torch(g_np), ss, cfg)
    assert [id(t) for t in T.leaves(out)] == ids
    for a, b in zip(T.leaves(out) + T.leaves(st), T.leaves(whole)
                    + T.leaves(sw)):
        assert torch.equal(a, b)
    assert int(st["step"]) == 1


# --------------------------------------------------------------------------
# int8 gradient compression
# --------------------------------------------------------------------------

def test_compress_and_error_feedback_are_bit_equal(ref):
    jnp = ref.jnp
    rng = np.random.default_rng(7)
    cases = [rng.standard_normal((64, 128)).astype(np.float32) * 0.01,
             rng.standard_normal((3, 5, 7)).astype(np.float32),
             rng.standard_normal((10,)).astype(np.float32),
             np.zeros((2, 4), np.float32),
             # exact halves of the int8 step: round half to even
             (np.arange(-8, 8, dtype=np.float32) + 0.5)[None] / 127.0 * 7.5]
    for g in cases:
        q, s = PC.compress(torch.as_tensor(g))
        rq, rs = ref.compression.compress(jnp.asarray(g))
        assert q.dtype == torch.int8 and tuple(s.shape) == rs.shape
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(PC.decompress(q, s).numpy(),
                                      np.asarray(ref.compression.decompress(
                                          rq, rs)))
    tree = dict(a=cases[0], b=[cases[1], cases[2]])
    err = T.tree_map(lambda x: (np.random.default_rng(8).standard_normal(
        x.shape) * 1e-3).astype(np.float32), tree)
    dq, ne = PC.apply_error_feedback(T.tree_map(torch.as_tensor, tree),
                                     T.tree_map(torch.as_tensor, err))
    rdq, rne = ref.compression.apply_error_feedback(
        ref.jax.tree.map(jnp.asarray, tree), ref.jax.tree.map(jnp.asarray,
                                                              err))
    for a, b in zip(T.leaves(dq) + T.leaves(ne),
                    ref.jax.tree.leaves(rdq) + ref.jax.tree.leaves(rne)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    z = PC.init_error_state(T.tree_map(torch.as_tensor, tree))
    assert all(t.dtype == torch.float32 and not t.any() for t in T.leaves(z))


def test_compression_roundtrip_error_bounded():
    """The reference's own test (tests/test_runtime.py), on a numpy draw."""
    g = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (64, 128)).astype(np.float32) * 0.01)
    q, s = PC.compress(g)
    err = (PC.decompress(q, s) - g).abs()
    assert float(err.max()) <= float(s.max()) / 2 + 1e-9   # half an int8 step


def test_error_feedback_reduces_bias():
    """The reference's own test: accumulated dequantized gradients converge
    to the accumulated true gradients; the residual is bounded by the final
    error buffer, not growing with the steps."""
    rng = np.random.default_rng(1)
    grads = [dict(w=torch.as_tensor(rng.standard_normal((32, 32)).astype(
        np.float32) * 0.01)) for _ in range(50)]
    err = PC.init_error_state(grads[0])
    acc_q = np.zeros((32, 32))
    acc_t = np.zeros((32, 32))
    for g in grads:
        dq, err = PC.apply_error_feedback(g, err)
        acc_q += dq["w"].numpy()
        acc_t += g["w"].numpy()
    resid = np.abs(acc_q - acc_t)
    assert resid.max() <= float(err["w"].abs().max()) + 1e-6


# --------------------------------------------------------------------------
# step functions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("compression", [False, True])
def test_train_step_matches_reference(ref, compression):
    """One ``make_train_step`` step against the reference's, on the same
    weights and batch (reduced qwen2-7b, one repeat): metrics, parameters,
    AdamW state and the error buffer."""
    jax, jnp = ref.jax, ref.jnp
    rcfg = ref.config_base.reduced(ref.configs.get_config("qwen2-7b"),
                                   repeats=1)
    cfg = reduced(get_config("qwen2-7b"), repeats=1)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    rc, pc = ref.adamw.AdamWConfig(**opt), PA.AdamWConfig(**opt)
    rp, rs = ref.steps.init_train_state(rcfg, rc, jax.random.PRNGKey(3))
    pp = params_from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu")
    ps = PA.adamw_init(pp, pc)
    rb, pb = _batches(ref, cfg, 2, 20, seed=3)
    rstep = jax.jit(ref.steps.make_train_step(rcfg, rc,
                                              grad_compression=compression))
    pstep = PS.make_train_step(cfg, pc, grad_compression=compression)
    if compression:
        rp, rs, rerr, rm = rstep(rp, rs, rb,
                                 ref.compression.init_error_state(rp))
        pp, ps, perr, pm = pstep(pp, ps, pb, PC.init_error_state(pp))
        for a, b in zip(T.leaves(perr), jax.tree.leaves(rerr)):
            # a gradient entry one f32 rounding apart can land on the other
            # side of an int8 rounding boundary, which moves its residual by
            # a whole quantization step: allow that at one entry in 1000,
            # every other residual to 1e-6
            moved = np.abs(_np32(a) - _np32(b)) > 1e-6
            assert moved.mean() <= 1e-3, moved.sum()
    else:
        rp, rs, rm = rstep(rp, rs, rb)
        pp, ps, pm = pstep(pp, ps, pb)
    assert set(pm) == set(rm)
    for k in ("loss", "total_loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-5,
                                   err_msg=k)
    assert int(pm["tokens"]) == int(rm["tokens"])
    lr = float(rm["lr"])
    for a, b in zip(T.leaves(pp), jax.tree.leaves(rp)):
        assert not a.requires_grad
        np.testing.assert_allclose(_np32(a), _np32(b), rtol=0,
                                   atol=PARAM_LR_TOL * lr)
    assert int(ps["step"]) == int(rs["step"]) == 1


def test_init_train_state_and_the_serving_steps():
    cfg = reduced(get_config("qwen2-7b"))
    opt = PA.AdamWConfig()
    params, state = PS.init_train_state(cfg, opt, seed=1, device="cpu")
    again, _ = PS.init_train_state(cfg, opt, seed=1, device="cpu")
    for a, b, m, v in zip(T.leaves(params), T.leaves(again),
                          T.leaves(state["m"]), T.leaves(state["v"])):
        assert torch.equal(a, b)
        assert m.shape == a.shape and m.dtype == torch.float32 and not m.any()
        assert v.shape == a.shape and not v.any()
    assert int(state["step"]) == 0
    toks = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 12)))
    logits, caches = PS.make_prefill_step(cfg, max_len=14)(
        params, {"tokens": toks})
    want, _ = PM.prefill(params, {"tokens": toks}, cfg, 14)
    assert torch.equal(logits, want)
    step_logits, _ = PS.make_decode_step(cfg)(params, logits.argmax(-1),
                                              caches, 12)
    assert step_logits.shape == (2, cfg.vocab_size)
    assert torch.isfinite(step_logits).all()


# --------------------------------------------------------------------------
# data pipeline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 123_456)])
def test_synthetic_batch_is_the_references_bit_for_bit(ref, seed, step):
    rd, pd = (m.DataConfig(global_batch=3, seq_len=17, vocab_size=101,
                           seed=seed) for m in (ref.pipeline, PD))
    got = PD.synthetic_batch(pd, step)
    want = ref.pipeline.synthetic_batch(rd, step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    got = PD.synthetic_batch(pd, step, frontend="audio_stub", d_model=8)
    want = ref.pipeline.synthetic_batch(rd, step, frontend="audio_stub",
                                        d_model=8)
    assert set(got) == set(want) == {"embeds", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for host in range(3):
        for k, v in PD.host_shard_batch(got, host, 3).items():
            np.testing.assert_array_equal(
                v, ref.pipeline.host_shard_batch(want, host, 3)[k])


def test_data_pipeline_deterministic():
    """The reference's own test (tests/test_runtime.py)."""
    dc = PD.DataConfig(global_batch=4, seq_len=16, vocab_size=101, seed=3)
    b1 = PD.synthetic_batch(dc, step=7)
    b2 = PD.synthetic_batch(dc, step=7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = PD.synthetic_batch(dc, step=8)
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


# --------------------------------------------------------------------------
# the tree order every module above relies on
# --------------------------------------------------------------------------

def test_tree_order_is_jax_tree_flatten_order(ref):
    state = dict(params=dict(z=1, a=[2, dict(y=3, b=4)]),
                 opt=dict(m=5, v=6, step=7))
    flat, treedef = T.flatten(state)
    assert flat == ref.jax.tree.leaves(state) == [5, 7, 6, 2, 4, 3, 1]
    assert T.unflatten(treedef, flat) == state
    assert T.tree_map(lambda a, b: a + b, state, state)["opt"]["step"] == 14
    with pytest.raises(ValueError):
        T.unflatten(treedef, flat + [8])
