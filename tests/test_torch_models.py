"""The port's LM stack against the JAX reference, layer by layer and end to
end, on the CPU.

Inputs are numpy draws from a seed; weights are the reference's own
``init_params`` carried into the port with ``params_from_reference``, so
both sides run the same numbers.  Layers, chunked and decode attention
(windows and query offsets included), the Mamba scan, prefill and decode
step, and MoE with capacity drops are compared at the reference's
tolerances; ``prefill`` logits and caches, then four ``decode_step``s, for
the reduced jamba-v0.1-52b, qwen2-7b and falcon-mamba-7b at the reference's
own 2e-4 (tests/test_models_smoke.py); ``repro_torch.serve``'s greedy tokens
against ``examples/serve_lm.py``'s, and its sampled ones at temperature 0.8
(reduced qwen2-vl-7b's stub embeddings and reduced jamba's tokens, token
for token).  Tests marked ``cuda`` run the reduced
jamba on the card through the kernels; they skip elsewhere.
"""
import importlib.util
import json
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_reference
from repro_torch.kernels import flash_attention as K3
from repro_torch.kernels import mamba_scan as K4
from repro_torch.kernels import rmsnorm as K5
from repro_torch.models import attention as PA
from repro_torch.models import layers as PL
from repro_torch.models import mamba as PMB
from repro_torch.models import model as PM
from repro_torch.models import moe as PMO
from repro_torch.models import transformer as PT
from repro_torch.serve import generate
from test_torch_harness import ROOT, load_reference

TOL = 2e-4          # the reference's decode-vs-forward tolerance


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda")


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got).astype(np.float64),
                               np.asarray(want).astype(np.float64),
                               atol=tol, rtol=tol)


def _tree_close(got, want, tol=TOL, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_close(got[k], want[k], tol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _tree_close(g, w, tol, f"{path}/{i}")
    else:
        assert tuple(got.shape) == tuple(np.shape(want)), path
        if np.issubdtype(np.asarray(want).dtype, np.integer):
            np.testing.assert_array_equal(_np(got), np.asarray(want),
                                          err_msg=path)
        else:
            np.testing.assert_allclose(_np(got).astype(np.float64),
                                       np.asarray(want, np.float64),
                                       atol=tol, rtol=tol, err_msg=path)


def _ref_params(ref, arch, seed):
    rcfg = ref.config_base.reduced(ref.configs.get_config(arch))
    rp = ref.model.init_params(rcfg, ref.jax.random.PRNGKey(seed))
    cfg = reduced(get_config(arch))
    tree = ref.jax.tree.map(np.asarray, rp)
    return rcfg, rp, cfg, params_from_reference(tree, cfg, "cpu")


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_rms_norm_rope_and_mlp_match_reference(ref):
    rng = np.random.default_rng(0)
    L = ref.layers
    jnp = ref.jnp
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32) + 1
    _close(PL.rms_norm(_t(x), _t(w), 1e-5),
           L.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), 2e-5)
    pos = np.arange(5)[None].repeat(2, 0) + np.array([[0], [7]])
    for theta in (10_000.0, 1_000_000.0):
        c, s = PL.rope_angles(torch.as_tensor(pos), 16, theta)
        rc, rs = L.rope_angles(jnp.asarray(pos), 16, theta)
        _close(c, rc, 2e-5)
        _close(s, rs, 2e-5)
        _close(PL.apply_rope(_t(x), c, s),
               L.apply_rope(jnp.asarray(x), rc, rs), 2e-5)
    mpos = PL.mrope_positions(2, 5, 3)
    np.testing.assert_array_equal(_np(mpos), np.asarray(
        L.mrope_positions(2, 5, 3)))
    c, s = PL.rope_angles(mpos, 16, 1e6, (2, 3, 3))
    rc, rs = L.rope_angles(L.mrope_positions(2, 5, 3), 16, 1e6, (2, 3, 3))
    _close(c, rc, 2e-5)
    _close(s, rs, 2e-5)
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    wg, wu = (rng.standard_normal((16, 24)).astype(np.float32) * 0.2
              for _ in range(2))
    wd = rng.standard_normal((24, 16)).astype(np.float32) * 0.2
    for act in ("silu", "gelu"):
        _close(PL.gated_mlp(_t(h), _t(wg), _t(wu), _t(wd), act),
               L.gated_mlp(*(jnp.asarray(a) for a in (h, wg, wu, wd)), act),
               2e-5)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

ATTN_CASES = [  # (B, Sq, Sk, H, Kv, hd, causal, window, chunk, q_offset)
    (2, 32, 32, 4, 2, 16, True, None, 8, 0),
    (1, 33, 33, 4, 1, 8, True, None, 8, 0),       # MQA + ragged
    (2, 24, 24, 8, 8, 8, False, None, 16, 0),     # encoder MHA
    (2, 48, 48, 4, 2, 16, True, 16, 8, 0),        # sliding window
    (1, 8, 24, 2, 2, 16, True, None, 8, 16),      # prefill continuation
    (1, 8, 24, 2, 1, 16, True, 8, 4, 16),         # continuation + window
]


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=[str(i) for i in range(len(ATTN_CASES))])
def test_chunked_attention_matches_reference(ref, case):
    B, Sq, Sk, H, Kv, hd, causal, window, chunk, q_offset = case
    rng = np.random.default_rng(Sq * Sk + hd)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, Kv, hd)).astype(np.float32)
            for _ in range(2))
    jnp = ref.jnp
    want = ref.attention.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_chunk=chunk, k_chunk=chunk, q_offset=q_offset)
    got = PA.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                               window=window, q_chunk=chunk, k_chunk=chunk,
                               q_offset=q_offset)
    _close(got, want, 3e-5)


@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention_matches_reference(ref, window):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
              for _ in range(2))
    jnp = ref.jnp
    want = ref.attention.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(13),
        window=window)
    _close(PA.decode_attention(_t(q), _t(kc), _t(vc), 13, window=window),
           want, 3e-5)
    slots = np.where(np.arange(20) < 15, np.arange(20), -1).astype(np.int32)
    want = ref.transformer._decode_attn_with_slots(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(slots),
        jnp.int32(13), window)
    _close(PT._decode_attn_with_slots(_t(q), _t(kc), _t(vc),
                                      torch.as_tensor(slots), 13, window),
           want, 3e-5)


# --------------------------------------------------------------------------
# mamba
# --------------------------------------------------------------------------

def _ssm(B, L, Di, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, Di)).astype(np.float32)
    delta = np.log1p(np.exp(rng.standard_normal((B, L, Di)) * 0.5)).astype(
        np.float32)
    A = (-np.exp(rng.standard_normal((Di, N)) * 0.3)).astype(np.float32)
    B_t, C_t = (rng.standard_normal((B, L, N)).astype(np.float32)
                for _ in range(2))
    D = np.ones(Di, np.float32)
    return x, delta, A, B_t, C_t, D


@pytest.mark.parametrize("L,chunk,impl", [(16, 4, "assoc"), (33, 8, "assoc"),
                                          (7, 16, "assoc"), (21, 8, "seq")])
def test_selective_scan_matches_reference(ref, L, chunk, impl):
    arrs = _ssm(2, L, 8, 4, L)
    jnp = ref.jnp
    want_y, want_h = ref.mamba.selective_scan_chunked(
        *(jnp.asarray(a) for a in arrs), chunk=chunk, impl=impl)
    y, h = PMB.selective_scan_chunked(*(_t(a) for a in arrs), chunk=chunk,
                                      impl=impl)
    _close(y, want_y, 1e-4)
    _close(h, want_h, 1e-4)
    _close(PMB.selective_scan_ref(*(_t(a) for a in arrs)),
           ref.mamba.selective_scan_ref(*(jnp.asarray(a) for a in arrs)),
           1e-4)
    # carry continuation, and the in-chunk bf16 scan elements
    y1, h1 = PMB.selective_scan_chunked(*(_t(a[:, :L // 2]) if a.ndim == 3
                                          else _t(a) for a in arrs),
                                        chunk=chunk, impl=impl)
    y2, _ = PMB.selective_scan_chunked(*(_t(a[:, L // 2:]) if a.ndim == 3
                                         else _t(a) for a in arrs),
                                       chunk=chunk, h0=h1, impl=impl)
    _close(torch.cat([y1, y2], 1), want_y, 1e-4)
    want_bf, _ = ref.mamba.selective_scan_chunked(
        *(jnp.asarray(a) for a in arrs), chunk=chunk,
        scan_dtype=jnp.bfloat16)
    got_bf, _ = PMB.selective_scan_chunked(*(_t(a) for a in arrs), chunk=chunk,
                                           scan_dtype=torch.bfloat16)
    _close(got_bf, want_bf, 2e-2)


def test_mamba_prefill_and_decode_match_reference(ref):
    rcfg, rp, cfg, p = _ref_params(ref, "falcon-mamba-7b", 5)
    mp_ref = ref.jax.tree.map(lambda a: a[0], rp["blocks"][0]["mamba"])
    mp = {k: v[0] for k, v in p["blocks"][0]["mamba"].items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    jnp = ref.jnp
    want, want_c = ref.mamba.mamba_prefill(mp_ref, jnp.asarray(x), rcfg)
    got, got_c = PMB.mamba_prefill(mp, _t(x), cfg)
    _close(got, want)
    _tree_close(got_c, want_c)
    _close(PMB.mamba_forward(mp, _t(x), cfg),
           ref.mamba.mamba_forward(mp_ref, jnp.asarray(x), rcfg))
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    want, want_c = ref.mamba.mamba_decode_step(mp_ref, jnp.asarray(x1),
                                               want_c, rcfg)
    got, got_c = PMB.mamba_decode_step(mp, _t(x1), got_c, cfg)
    _close(got, want)
    _tree_close(got_c, want_c)


# --------------------------------------------------------------------------
# moe
# --------------------------------------------------------------------------

class _MoeCfg:
    def __init__(self, D, E, k, F, cf):
        self.d_model, self.n_experts, self.experts_per_token = D, E, k
        self.moe_d_ff, self.capacity_factor, self.mlp_act = F, cf, "silu"


@pytest.mark.parametrize("cf,G,S", [(8.0, 4, 24), (1.0, 2, 64), (0.5, 3, 20)])
def test_moe_matches_reference_with_capacity_drops(ref, cf, G, S):
    D, E, k, F = 32, 8, 2, 16
    rng = np.random.default_rng(int(cf * 10) + S)
    params = dict(router=rng.standard_normal((D, E)) * 0.1,
                  wg=rng.standard_normal((E, D, F)) * 0.1,
                  wu=rng.standard_normal((E, D, F)) * 0.1,
                  wd=rng.standard_normal((E, F, D)) * 0.1)
    params = {n: a.astype(np.float32) for n, a in params.items()}
    x = rng.standard_normal((G, S, D)).astype(np.float32)
    cfg = _MoeCfg(D, E, k, F, cf)
    jnp = ref.jnp
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    want_y, want_aux = ref.moe.moe_forward(jp, jnp.asarray(x), cfg)
    tp = {n: _t(a) for n, a in params.items()}
    y, aux = PMO.moe_forward(tp, _t(x), cfg)
    _close(y, want_y, 1e-5)
    _close(aux, want_aux, 1e-5)
    _close(PMO.moe_ref(tp, _t(x), cfg), ref.moe.moe_ref(jp, jnp.asarray(x),
                                                        cfg), 1e-5)
    C = PMO.capacity(S, E, k, cf)
    assert C == ref.moe.capacity(S, E, k, cf)
    if cf < 1.5:                 # some assignments overflow and are dropped
        logits = _t(x) @ tp["router"]
        dispatch, _, _, valid = PMO._route_group(logits, k, C, E)
        assert int(valid.sum()) < G * S * k
    assert PMO.capacity(4096, 384, 8, 1.25) == 107


def test_moe_float8_dispatch_is_not_ported(ref):
    """The float8 dispatch, refused until the port carried it, now runs:
    all-zero inputs give zeros (empty slots scale to 1e-12, no NaN), and
    drawn inputs the reference's output (compiled, f32) within 1e-5
    (tests/test_torch_moe_fp8.py holds it further)."""
    cfg = _MoeCfg(8, 2, 1, 4, 2.0)
    cfg.moe_dispatch_dtype = "float8_e4m3fn"
    p = dict(router=torch.zeros(8, 2), wg=torch.zeros(2, 8, 4),
             wu=torch.zeros(2, 8, 4), wd=torch.zeros(2, 4, 8))
    y, aux = PMO.moe_forward(p, torch.zeros(1, 3, 8), cfg)
    assert not y.any() and torch.isfinite(aux)
    rng = np.random.default_rng(8)
    w = {n: (rng.standard_normal(t.shape) * 0.3).astype(np.float32)
         for n, t in p.items()}
    x = rng.standard_normal((2, 6, 8)).astype(np.float32)
    want, _ = ref.jax.jit(lambda pp, xx: ref.moe.moe_forward(pp, xx, cfg))(
        {n: ref.jnp.asarray(a) for n, a in w.items()}, ref.jnp.asarray(x))
    got, _ = PMO.moe_forward({n: torch.from_numpy(a) for n, a in w.items()},
                             torch.from_numpy(x), cfg)
    want = np.asarray(want, np.float64)
    assert np.linalg.norm(got.numpy() - want) <= 1e-5 * np.linalg.norm(want)


# --------------------------------------------------------------------------
# the whole model: prefill + decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "qwen2-7b",
                                  "falcon-mamba-7b"])
def test_prefill_and_decode_match_reference(ref, arch):
    rcfg, rp, cfg, p = _ref_params(ref, arch, 2)
    B, S, EXTRA = 2, 16, 4
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + EXTRA)).astype(np.int32)
    jnp = ref.jnp
    want, want_c = ref.model.prefill(rp, {"tokens": jnp.asarray(toks[:, :S])},
                                     rcfg, max_len=S + EXTRA)
    got, got_c = PM.prefill(p, {"tokens": torch.as_tensor(toks[:, :S])}, cfg,
                            max_len=S + EXTRA)
    assert got.shape == (B, cfg.vocab_size) and got.dtype == torch.float32
    _close(got, want)
    _tree_close(got_c, want_c)
    for i in range(EXTRA):
        want, want_c = ref.model.decode_step(
            rp, jnp.asarray(toks[:, S + i]), want_c, jnp.int32(S + i), rcfg)
        got, got_c = PM.decode_step(p, torch.as_tensor(toks[:, S + i]),
                                    got_c, S + i, cfg)
        _close(got, want)
        _tree_close(got_c, want_c)


def test_decode_matches_forward_in_the_port():
    """Teacher-forced decode logits == full-forward logits, per position:
    the reference's identity, on the port alone (its own init)."""
    cfg = reduced(get_config("jamba-v0.1-52b"))
    p = PM.init_params(cfg, seed=3, device="cpu")
    B, S, EXTRA = 2, 12, 4
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S + EXTRA)))
    h, aux = PM.forward_hidden(p, {"tokens": toks}, cfg)
    assert torch.isfinite(aux)
    full = PM._logits(p, h, cfg)
    logits, caches = PM.prefill(p, {"tokens": toks[:, :S]}, cfg,
                                max_len=S + EXTRA)
    _close(logits, _np(full[:, S - 1]))
    for i in range(EXTRA):
        logits, caches = PM.decode_step(p, toks[:, S + i], caches, S + i, cfg)
        _close(logits, _np(full[:, S + i]))


def test_init_params_shapes_and_special_init():
    cfg = reduced(get_config("jamba-v0.1-52b"))
    p = PM.init_params(cfg, seed=0, device="cpu")
    q = PM.init_params(cfg, seed=0, device="cpu")
    shapes = PM.param_shapes(cfg)

    def walk(t, s, name=""):
        if isinstance(s, dict):
            assert set(t) == set(s)
            for k in s:
                walk(t[k], s[k], k)
        elif isinstance(s, list):
            for a, b in zip(t, s):
                walk(a, b, name)
        else:
            assert tuple(t.shape) == tuple(s), name
    walk(p, shapes)
    m = p["blocks"][0]["mamba"]
    N = cfg.ssm_state
    assert m["A_log"].dtype == torch.float32 and m["D"].dtype == torch.float32
    _close(m["A_log"][0, 3], np.log(np.arange(1, N + 1)), 1e-7)
    assert torch.all(m["D"] == 1) and torch.all(m["conv_b"] == 0)
    assert torch.all(p["blocks"][0]["norm1"] == 1)
    assert torch.all(p["final_norm"] == 1)
    assert abs(float(p["embed"].std(correction=0)) - 0.02) < 1e-6
    w = p["blocks"][1]["moe"]["wg"]
    assert float(w.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) + 1e-7
    assert torch.equal(p["head"], q["head"])           # seeded


def test_params_from_reference_carries_bf16_and_checks_the_tree(ref):
    jnp = ref.jnp
    cfg = reduced(get_config("qwen2-7b"))
    rcfg = ref.config_base.reduced(ref.configs.get_config("qwen2-7b"))
    rp = ref.model.init_params(rcfg, ref.jax.random.PRNGKey(1))
    tree = ref.jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), rp)
    p = params_from_reference(tree, cfg, "cpu")
    assert p["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(p["embed"].float()), np.asarray(rp["embed"].astype(
            jnp.bfloat16).astype(jnp.float32)))
    del tree["head"]
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(tree, cfg, "cpu")


def test_serve_matches_the_reference_serving_example(ref, monkeypatch, capsys):
    """``repro_torch.serve.generate`` makes the same greedy tokens as
    ``examples/serve_lm.py`` on the same weights and prompts (reduced
    jamba, f32): the example's own init (PRNGKey(0)) and prompts, carried
    into the port."""
    spec = importlib.util.spec_from_file_location(
        "serve_lm_example", ROOT / "examples" / "serve_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    B, S, NEW = 2, 16, 5
    monkeypatch.setattr(sys, "argv", [
        "serve_lm.py", "--arch", "jamba-v0.1-52b", "--requests", str(B),
        "--prompt-len", str(S), "--max-new", str(NEW)])
    example.main()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("request ")]
    want = [eval(ln.split(":", 1)[1]) for ln in lines]
    # the example's weights and prompts, made as it makes them
    jax = ref.jax
    rcfg = ref.config_base.reduced(ref.configs.get_config("jamba-v0.1-52b"))
    key = jax.random.PRNGKey(0)
    rp = ref.model.init_params(rcfg, key)
    prompts = np.asarray(jax.random.randint(key, (B, S), 0, rcfg.vocab_size))
    cfg = reduced(get_config("jamba-v0.1-52b"))
    p = params_from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu")
    res = generate(p, cfg, torch.as_tensor(np.array(prompts)), NEW)
    assert res.tokens.tolist() == want
    assert res.decode_steps == NEW - 1 and res.prefill_s > 0


#: the sampled serving runs: the example's stub-frontend config and a
#: token config with MoE and Mamba layers
SAMPLED_ARCHS = ["qwen2-vl-7b", "jamba-v0.1-52b"]


@pytest.mark.parametrize("arch", SAMPLED_ARCHS)
def test_sampled_serving_matches_the_reference_serving_example(
        ref, monkeypatch, capsys, arch):
    """``generate(temperature=0.8, key=0)`` makes the tokens of
    ``examples/serve_lm.py --temperature 0.8`` token for token on the same
    weights: reduced qwen2-vl-7b (a vision stub: prompts as
    ``normal(key, (B, S, D))`` embeddings, each decode step fed
    ``normal(fold_in(key, i), (B, D))``) and reduced jamba (token
    prompts).  Each decode step samples ``categorical(fold_in(key, 100 +
    i), logits / 0.8)``; the first token is the prefill's argmax.  The
    port's own prompts (``serving_prompts``) are the example's bits."""
    from repro_torch.serve import serving_prompts

    spec = importlib.util.spec_from_file_location(
        "serve_lm_example", ROOT / "examples" / "serve_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    B, S, NEW = 2, 16, 6
    monkeypatch.setattr(sys, "argv", [
        "serve_lm.py", "--arch", arch, "--requests", str(B),
        "--prompt-len", str(S), "--max-new", str(NEW), "--temperature",
        "0.8"])
    example.main()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("request ")]
    want = [eval(ln.split(":", 1)[1]) for ln in lines]
    jax = ref.jax
    rcfg = ref.config_base.reduced(ref.configs.get_config(arch))
    key = jax.random.PRNGKey(0)
    rp = ref.model.init_params(rcfg, key)
    cfg = reduced(get_config(arch))
    p = params_from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu")
    prompts = serving_prompts(cfg, B, S, 0, "cpu")
    if cfg.frontend != "none":
        embeds = np.asarray(jax.random.normal(key, (B, S, cfg.d_model)))
        np.testing.assert_array_equal(prompts.numpy().view(np.uint32),
                                      embeds.view(np.uint32))
    else:
        np.testing.assert_array_equal(prompts.numpy(), np.asarray(
            jax.random.randint(key, (B, S), 0, rcfg.vocab_size)))
    res = generate(p, cfg, prompts, NEW, temperature=0.8, key=0)
    assert res.tokens.tolist() == want
    greedy = generate(p, cfg, prompts, NEW)
    assert greedy.tokens[:, 0].tolist() == res.tokens[:, 0].tolist()
    assert greedy.tokens.tolist() != res.tokens.tolist()


def test_generate_refuses_what_the_reference_cannot_serve():
    """An encoder-only config has no decode step (the CLI exits, as the
    example does); a stub-frontend config takes (B, S, D) embeddings, a
    token config (B, S) ids; the temperature is not negative."""
    from repro_torch import serve

    enc = reduced(get_config("hubert-xlarge"))
    with pytest.raises(ValueError, match="encoder-only"):
        generate({}, enc, torch.zeros(1, 4, enc.d_model), 2)
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                    "cpu"])
    vl = reduced(get_config("qwen2-vl-7b"))
    with pytest.raises(ValueError, match="embeddings"):
        generate({}, vl, torch.zeros(1, 4, dtype=torch.long), 2)
    lm = reduced(get_config("qwen2-7b"))
    with pytest.raises(ValueError, match="token ids"):
        generate({}, lm, torch.zeros(1, 4, lm.d_model), 2)
    with pytest.raises(ValueError, match="temperature"):
        generate({}, lm, torch.zeros(1, 4, dtype=torch.long), 2,
                 temperature=-1.0)


def test_serve_cli_samples_a_stub_frontend_config(capsys):
    """``python -m repro_torch.serve --arch qwen2-vl-7b --reduced --device
    cpu --temperature 0.8``: one JSON line with the sampled tokens of the
    vision-stub config, the same on a second run (one key)."""
    from repro_torch import serve

    argv = ["--arch", "qwen2-vl-7b", "--reduced", "--device", "cpu",
            "--temperature", "0.8", "--requests", "2", "--prompt-len", "8",
            "--max-new", "4"]
    out = serve.main(argv)
    assert json.loads(capsys.readouterr().out.strip()) == out
    assert out["frontend"] == "vision_stub" and out["temperature"] == 0.8
    assert np.array(out["tokens"]).shape == (2, 4)
    assert serve.main(argv)["tokens"] == out["tokens"]


def test_smoke_routing_replay_reproduces_the_recorded_run():
    """``chip_smoke.py`` compares the kernels with their plain versions on
    a prefill that replays the kernel run's MoE expert choices.  Replaying
    a run's own choices gives its logits bit for bit; replaying other
    choices takes them, while each call's own choice is still recorded;
    the plain-version swap restores every kernel wrapper."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = reduced(get_config("jamba-v0.1-52b"))
    k, E = cfg.experts_per_token, cfg.n_experts
    p = PM.init_params(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)))

    def prefill():
        return PM.prefill(p, {"tokens": toks}, cfg, 28)[0]

    with smoke._moe_routes() as first:
        want = prefill()
    assert len(first) == sum(s.moe for s in cfg.pattern) * cfg.n_repeats
    with smoke._moe_routes(replay=first) as again:
        assert torch.equal(prefill(), want)
    assert smoke._assignments_differ(torch, first, again, k) == 0
    other = [(r + 1) % E for r in first]
    with smoke._moe_routes(replay=other) as own:
        moved = prefill()
    assert not torch.allclose(moved, want)
    assert torch.equal(own[0], first[0])     # the first MoE layer's input
    assert smoke._assignments_differ(torch, other, own, k) > 0
    wrappers = (K5.rmsnorm_cuda, K3.flash_attention_cuda, K4.mamba_scan_cuda)
    with smoke._plain_kernels():
        assert K5.rmsnorm_cuda is K5.rmsnorm_ref
        assert K3.flash_attention_cuda is K3.attention_ref
        assert K4.mamba_scan_cuda is K4.mamba_scan_ref
    assert (K5.rmsnorm_cuda, K3.flash_attention_cuda,
            K4.mamba_scan_cuda) == wrappers


# --------------------------------------------------------------------------
# on the card: the reduced model through the kernels
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_reduced_jamba_on_card_goes_through_the_kernels(cuda_device,
                                                       monkeypatch):
    cfg = reduced(get_config("jamba-v0.1-52b"))
    p = PM.init_params(cfg, seed=0, device=cuda_device)
    B, S = 2, 40
    toks = torch.randint(0, cfg.vocab_size, (B, S + 3), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    with monkeypatch.context() as m:      # the same prefill, plain versions
        m.setattr(K5, "rmsnorm_cuda", K5.rmsnorm_ref)
        m.setattr(K3, "flash_attention_cuda", K3.attention_ref)
        m.setattr(K4, "mamba_scan_cuda", K4.mamba_scan_ref)
        want, want_c = PM.prefill(p, {"tokens": toks[:, :S]}, cfg, S + 3)
    for mod in (K3, K4, K5):
        mod.reset_launches()
    got, got_c = PM.prefill(p, {"tokens": toks[:, :S]}, cfg, S + 3)
    torch.cuda.synchronize()
    n_attn = sum(s.kind == "attn" for s in cfg.pattern) * cfg.n_repeats
    assert K5.launches() == 2 * cfg.n_layers + 1
    assert K3.launches() == n_attn
    assert K4.launches() == cfg.n_layers - n_attn
    _close(got, _np(want), 1e-3)
    _tree_close(got_c, [{k: _np(v) for k, v in c.items()} for c in want_c],
                1e-3)
    K5.reset_launches()
    logits, _ = PM.decode_step(p, toks[:, S], got_c, S, cfg)
    assert K5.launches() == 2 * cfg.n_layers + 1
    assert torch.isfinite(logits).all()


@pytest.mark.cuda
def test_windowed_attention_raises_on_card(cuda_device):
    """Windowed layers no longer raise on the card: a reduced gemma3-12b
    (5 windowed layers to 1 global) prefills there as on the CPU, its
    windowed layers through the plain ``chunked_attention`` and only its
    global layers through K3."""
    cfg = reduced(get_config("gemma3-12b"))
    p = PM.init_params(cfg, seed=0, device="cpu")
    B, S = 2, 40                   # past the reduced window of 8
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, S)))
    want, want_c = PM.prefill(p, {"tokens": toks}, cfg, S + 2)
    p_dev = {k: _to(v, cuda_device) for k, v in p.items()}
    K3.reset_launches()
    got, got_c = PM.prefill(p_dev, {"tokens": toks.to(cuda_device)}, cfg,
                            S + 2)
    torch.cuda.synchronize()
    n_global = sum(s.window is None for s in cfg.pattern) * cfg.n_repeats
    assert 0 < n_global < cfg.n_layers
    assert K3.launches() == n_global
    _close(got, _np(want), 1e-3)
    _tree_close(got_c, [{k: _np(v) for k, v in c.items()} for c in want_c],
                1e-3)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_lm_entry_points_default_to_the_card():
    """The serving and training paths' entry points run on the card unless
    asked for the CPU, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch import elastic_demo, serve, train_lm
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.train.steps import init_train_state

    cfg = reduced(get_config("jamba-v0.1-52b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PM.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced", "--max-new", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_reference({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, AdamWConfig(), DataConfig(2, 8, cfg.vocab_size),
                TrainerConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(cfg, AdamWConfig(), seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lm.main(["--arch", "qwen2-7b", "--reduced", "--steps", "1",
                       "--ckpt-dir", ""])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        elastic_demo.main([])
    with pytest.raises(ValueError, match="multiple"):
        serve.serving_config("jamba-v0.1-52b", layers=12)
