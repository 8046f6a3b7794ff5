"""The port's training runtime against the JAX reference, on the CPU:
checkpoints (the reference's own tests, and checkpoints crossing between
the packages leaf for leaf), the fault-tolerance primitives, the trainer
(the port's 8-step history against the reference trainer's from the same
initial state, with and without int8 gradient compression; restart
equivalence), and ``python -m repro_torch.train_lm`` /
``python -m repro_torch.elastic_demo`` on the CPU.  Tests marked ``cuda``
train on the card; they skip elsewhere (run them there with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_runtime.py``).

Tolerances:

* the trainer's loss and grad-norm curves against the reference's:
  ``CURVE_TOL`` = 1e-4 absolute (both sum in f32 in other orders; measured
  <= 5e-7 over 8 steps);
* with gradient compression, ``COMPRESSED_CURVE_TOL`` = 1e-3: a gradient
  entry that the two frameworks round one f32 ulp apart can fall on the
  other side of an int8 rounding boundary, which moves that entry by one
  quantization step (max |g| of its row / 127) and so its Adam step by up
  to 2 lr; each such flip moves the next loss by at most 2 lr max |dL/dp|
  (~2e-4 at lr 1e-3 here), and a 1e-3 bound allows a handful (measured
  <= 4e-6);
* learning rates to 1e-6 relative (test_torch_train.py: one ulp of f32
  ``cos``);
* restart against the straight run: 1e-4, as the reference's own test.
"""
import importlib
import json

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import checkpoint as PCK
from repro_torch.runtime import fault_tolerance as PFT
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from test_torch_harness import load_reference

CURVE_TOL = 1e-4
COMPRESSED_CURVE_TOL = 1e-3


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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda")


def _tiny_cfg():
    return reduced(get_config("qwen2-7b"), repeats=1)


def _mk_trainer(tmp, device="cpu", **kw):
    """The reference's ``tests/test_runtime.py`` trainer, in the port."""
    cfg = _tiny_cfg()
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    data = DataConfig(global_batch=4, seq_len=32, vocab_size=cfg.vocab_size)
    tcfg = TrainerConfig(total_steps=kw.pop("total_steps", 8),
                         ckpt_every=kw.pop("ckpt_every", 4),
                         ckpt_dir=str(tmp / "ckpt"), **kw)
    return Trainer(cfg, opt, data, tcfg, device=device)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _state():
    return dict(a=torch.arange(10, dtype=torch.float32),
                b=[torch.ones((3, 3), dtype=torch.bfloat16) * 1.5,
                   torch.zeros(2)],
                step=torch.tensor(7, dtype=torch.int32))


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    PCK.save_checkpoint(str(tmp_path), 7, state)
    like = T.tree_map(torch.zeros_like, state)
    restored, step = PCK.restore_checkpoint(str(tmp_path), like)
    assert step == 7
    for x, y in zip(T.leaves(state), T.leaves(restored)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_gc_and_latest(tmp_path):
    state = dict(a=torch.zeros(3))
    for s in (1, 2, 3, 4, 5):
        PCK.save_checkpoint(str(tmp_path), s, state, keep=3)
    assert PCK.list_checkpoints(str(tmp_path)) == [3, 4, 5]
    assert PCK.latest_step(str(tmp_path)) == 5
    assert PCK.list_checkpoints(str(tmp_path / "none")) == []
    assert PCK.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        PCK.restore_checkpoint(str(tmp_path / "none"), state)


def test_checkpoint_torn_latest_falls_back(tmp_path):
    state = dict(a=torch.zeros(3))
    PCK.save_checkpoint(str(tmp_path), 1, state)
    PCK.save_checkpoint(str(tmp_path), 2, state)
    (tmp_path / "LATEST").write_text("step_000000099")
    assert PCK.latest_step(str(tmp_path)) == 2


def test_checkpoint_rejects_another_tree(tmp_path):
    PCK.save_checkpoint(str(tmp_path), 1, dict(a=torch.zeros(3)))
    with pytest.raises(ValueError, match="leaves"):
        PCK.restore_checkpoint(str(tmp_path), dict(a=torch.zeros(3),
                                                   b=torch.zeros(1)))
    with pytest.raises(ValueError, match="shape"):
        PCK.restore_checkpoint(str(tmp_path), dict(a=torch.zeros(4)))


def _ref_state(ref):
    """A training-state-shaped tree for the reference: params with a bf16
    leaf and a stacked list, opt with f32 m / v and an int32 step."""
    jnp = ref.jnp
    rng = np.random.default_rng(3)
    params = dict(blocks=[dict(w=jnp.asarray(rng.standard_normal((2, 3, 4)),
                                             jnp.float32),
                               norm1=jnp.ones((2, 3), jnp.bfloat16) * 1.25)],
                  embed=jnp.asarray(rng.standard_normal((5, 3)),
                                    jnp.bfloat16),
                  final_norm=jnp.asarray(rng.standard_normal(3), jnp.float32))
    zeros = ref.jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
        a.shape), jnp.float32), params)
    return dict(params=params, opt=dict(m=zeros, v=zeros,
                                        step=jnp.int32(11)))


def test_checkpoints_cross_between_the_packages(ref, tmp_path):
    """A reference-written checkpoint restores in the port and a
    port-written one in the reference, equal leaf for leaf in the right
    dtypes; both manifests agree in everything but the treedef string."""
    jax = ref.jax
    rstate = _ref_state(ref)
    ref.checkpoint.save_checkpoint(str(tmp_path / "r"), 3, rstate)
    from repro_torch.interop import _tensor_from_numpy
    pstate = T.tree_map(lambda a: _tensor_from_numpy(np.asarray(a),
                                                     torch.device("cpu")),
                        jax.tree.map(np.asarray, rstate))
    like = T.tree_map(torch.zeros_like, pstate)
    got, step = PCK.restore_checkpoint(str(tmp_path / "r"), like)
    assert step == 3
    for a, b in zip(T.leaves(got), jax.tree.leaves(rstate)):
        assert str(a.dtype) == "torch." + str(b.dtype)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    PCK.save_checkpoint(str(tmp_path / "p"), 3, pstate)
    back, step = ref.checkpoint.restore_checkpoint(
        str(tmp_path / "p"), jax.tree.map(ref.jnp.zeros_like, rstate))
    assert step == 3
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    mr, mp = (json.loads((tmp_path / d / "step_000000003" /
                          "manifest.json").read_text()) for d in ("r", "p"))
    assert mr.pop("treedef") and mp.pop("treedef")
    assert mr == mp
    # opt/m, opt/step, opt/v, then params/blocks/0/{norm1, w}, embed, ...
    assert mr["dtypes"][4] == "int32"
    assert mr["dtypes"][-4:] == ["bfloat16", "float32", "bfloat16", "float32"]


# --------------------------------------------------------------------------
# fault tolerance
# --------------------------------------------------------------------------

def test_straggler_monitor_flags_outlier(ref):
    """The reference's own test, and the same decisions as the reference's
    monitor on a noisy series."""
    m = PFT.StragglerMonitor(window=16, min_samples=4, threshold=3.0)
    for i in range(8):
        m.step_end(i, duration=1.0 + 0.01 * (i % 2))
    assert not m.flagged
    assert m.step_end(9, duration=5.0)
    assert m.flagged and m.flagged[0][0] == 9
    series = np.random.default_rng(5).lognormal(0, 0.3, 200)
    mine, theirs = PFT.StragglerMonitor(), ref.fault_tolerance.StragglerMonitor()
    assert ([mine.step_end(i, float(d)) for i, d in enumerate(series)]
            == [theirs.step_end(i, float(d)) for i, d in enumerate(series)])
    assert mine.flagged == theirs.flagged and mine.flagged


def test_elastic_plan_reshard_and_certificate(ref):
    plan = PFT.plan_elastic_remesh(n_devices=512, lost=16, model_axis=16)
    assert plan.new_devices == 496 // 16 * 16 == 496
    assert plan.new_mesh_shape == (31, 16)
    assert plan == PFT.ElasticPlan(**vars(
        ref.fault_tolerance.plan_elastic_remesh(512, 16, 16)))
    with pytest.raises(ValueError):
        PFT.plan_elastic_remesh(n_devices=8, lost=4, model_axis=8)
    tree = dict(w=np.ones((4, 4), np.float32), b=[torch.zeros(2)])
    out = PFT.reshard(tree, "cpu")
    assert isinstance(out["w"], torch.Tensor) and out["w"].device.type == "cpu"
    assert torch.equal(out["w"], torch.ones(4, 4))
    out = PFT.reshard(tree, dict(w="cpu", b=[torch.device("cpu")]))
    assert out["b"][0].device.type == "cpu"
    for n, k, alpha in ((4896, 18, 0.95), (4896, 18, 0.8), (2184, 6, 0.9)):
        cert = PFT.degraded_operation_certificate(n=n, radix=k, alpha=alpha)
        want = ref.fault_tolerance.degraded_operation_certificate(
            n=n, radix=k, alpha=alpha)
        assert cert.guaranteed_bisection_edges > 0 or alpha < 0.9
        np.testing.assert_allclose(cert.guaranteed_bisection_edges,
                                   want.guaranteed_bisection_edges,
                                   rtol=1e-12)


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("compression", [False, True])
def test_trainer_matches_the_reference_trainer(ref, tmp_path, compression):
    """The reference trainer's initial state, saved as a step-0 checkpoint,
    restored into the port's Trainer; both then train 8 steps (reduced
    qwen2-7b, the reference's test_runtime setup) and their histories
    agree: loss and grad norm within CURVE_TOL (COMPRESSED_CURVE_TOL with
    compression), lr within 1e-6 relative, the straggler flags equal."""
    RT = ref.trainer
    rcfg = ref.config_base.reduced(ref.configs.get_config("qwen2-7b"),
                                   repeats=1)
    ropt = ref.adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    rdata = ref.pipeline.DataConfig(global_batch=4, seq_len=32,
                                    vocab_size=rcfg.vocab_size)
    rt = RT.Trainer(rcfg, ropt, rdata, RT.TrainerConfig(
        total_steps=8, ckpt_every=100, grad_compression=compression))
    rt.init_or_restore()
    ckpt = tmp_path / "start"
    ref.checkpoint.save_checkpoint(str(ckpt), 0,
                                   dict(params=rt.params, opt=rt.opt_state))
    want = rt.run()

    cfg = _tiny_cfg()
    pt = Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50),
                 DataConfig(4, 32, cfg.vocab_size),
                 TrainerConfig(total_steps=8, ckpt_every=100,
                               ckpt_dir=str(ckpt),
                               grad_compression=compression),
                 device="cpu")
    assert pt.init_or_restore() == 0
    got = pt.run()
    tol = COMPRESSED_CURVE_TOL if compression else CURVE_TOL
    assert [h["step"] for h in got] == [h["step"] for h in want] == list(
        range(1, 9))
    assert set(got[0]) == set(want[0])
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= tol, (g, w)
        assert abs(g["total_loss"] - w["total_loss"]) <= tol, (g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= tol, (g, w)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        assert g["tokens"] == w["tokens"] == 4 * 32
    assert got[-1]["loss"] < got[0]["loss"] + 1.0
    assert PCK.list_checkpoints(str(ckpt)) == [0]       # ckpt_every 100


def test_restart_equivalence(tmp_path):
    """Train 8 steps straight == train 4, 'crash', restore, train 4 more
    (the reference's own test, in the port)."""
    t1 = _mk_trainer(tmp_path / "a", total_steps=8, ckpt_every=4)
    t1.init_or_restore()
    h1 = t1.run()
    t2 = _mk_trainer(tmp_path / "b", total_steps=8, ckpt_every=4)
    t2.init_or_restore()
    t2.run(steps=4)
    t3 = _mk_trainer(tmp_path / "b", total_steps=8, ckpt_every=4)
    assert t3.init_or_restore() == 4
    h3 = t3.run()
    assert abs(h3[-1]["loss"] - h1[-1]["loss"]) < 1e-4
    assert [h["step"] for h in h3] == [5, 6, 7, 8]
    assert PCK.list_checkpoints(str(tmp_path / "b" / "ckpt")) == [4, 8]


def test_trainer_grad_compression_trains(tmp_path):
    """The reference's own test, in the port."""
    t = _mk_trainer(tmp_path, total_steps=6, ckpt_every=100,
                    grad_compression=True)
    t.init_or_restore()
    h = t.run()
    assert np.isfinite(h[-1]["loss"])
    assert h[-1]["loss"] < h[0]["loss"] + 1.0
    assert all(k in h[-1] for k in ("loss", "lr", "grad_norm", "straggler"))


# --------------------------------------------------------------------------
# the command-line entry points
# --------------------------------------------------------------------------

def test_train_lm_resumes_from_its_checkpoint(tmp_path, capsys):
    """``python -m repro_torch.train_lm --arch qwen2-7b --reduced --device
    cpu``: 6 steps with a checkpoint every 3, then the same command with
    --steps 9 resumes at 6 and continues the straight 9-step run's curve."""
    TL = importlib.import_module("repro_torch.train_lm")
    args = ["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-every", "3"]
    straight = TL.main(args + ["--steps", "9", "--ckpt-dir",
                               str(tmp_path / "straight")])
    first = TL.main(args + ["--steps", "6", "--ckpt-dir",
                            str(tmp_path / "ck")])
    again = TL.main(args + ["--steps", "9", "--ckpt-dir",
                            str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 6" in out
    assert first["resumed_from"] == 0 and again["resumed_from"] == 6
    assert len(first["loss"]) == 6 and len(again["loss"]) == 3
    assert again["reduced"] == ["reduced config (tiny widths, experts, vocab)"]
    assert again["peak_memory_gb"] == "not measured"
    # the lr schedule follows --steps, so compare with a straight run of 9
    np.testing.assert_allclose(first["loss"] + again["loss"],
                               straight["loss"], atol=1e-4)
    assert json.loads(out.strip().splitlines()[-1]) == again


def test_elastic_demo_on_the_cpu(capsys):
    ED = importlib.import_module("repro_torch.elastic_demo")
    res = ED.main(["--device", "cpu"])
    assert res["resumed_at"] == 12
    assert np.isfinite(res["loss_step_24"])
    assert res["plan"].new_mesh_shape == (31, 16)
    out = capsys.readouterr().out
    assert "resumed at step 12" in out and "alpha=0.80" in out


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_reduced_trainer_on_card_matches_cpu(cuda_device, tmp_path):
    """The reduced qwen2-7b trained 4 steps on the card (K5, K3 forward,
    their plain versions' backward) and on the CPU from the same initial
    state: losses and grad norms within 1e-4 (f32; the card's products
    sum in other orders)."""
    a = _mk_trainer(tmp_path / "cpu", ckpt_every=100)
    a.init_or_restore()
    a.save()
    b = _mk_trainer(tmp_path / "cpu", device=cuda_device, ckpt_every=100)
    assert b.init_or_restore() == 0
    ha, hb = a.run(steps=4), b.run(steps=4)
    for x, y in zip(hb, ha):
        assert abs(x["loss"] - y["loss"]) <= 1e-4, (x, y)
        assert abs(x["grad_norm"] - y["grad_norm"]) <= 1e-4 * max(
            1.0, y["grad_norm"]), (x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_launch_counts_on_card(cuda_device, remat):
    """One train step of the reduced qwen2-7b on the card launches K5
    2L + 1 times in the forward and K3 L times, and with remat each layer's
    K5 and K3 again in the backward's recompute."""
    import dataclasses

    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import rmsnorm as K5
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.steps import make_train_step
    from repro_torch.models import model as PM

    cfg = dataclasses.replace(reduced(get_config("qwen2-7b")), remat=remat)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    params = PM.init_params(cfg, seed=0, device=cuda_device)
    state = adamw_init(params, opt)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(0))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    for mod in (K3, K5):
        mod.reset_launches()
    _, _, m = make_train_step(cfg, opt)(params, state, batch)
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert K5.launches() == 2 * L + 1 + (2 * L if remat else 0)
    assert K3.launches() == L + (L if remat else 0)
    assert np.isfinite(float(m["loss"]))


# --------------------------------------------------------------------------
# chip_smoke.py's training figures, checked by hand here
# --------------------------------------------------------------------------

def test_chip_smoke_training_counts_and_flops():
    """The launch counts the smoke's training phases assert (K3's backward
    kernel once a K3 layer, remat or not), its model FLOPs and the
    full-width configuration's size, against hand counts."""
    import dataclasses

    from repro_torch.models import model as PM
    from repro_torch.serve import serving_config
    from test_torch_harness import load_chip_smoke

    smoke = load_chip_smoke()
    cfg = serving_config("qwen2-7b", layers=12)
    assert (cfg.remat, cfg.loss_chunk, cfg.d_model, cfg.d_ff,
            cfg.vocab_size) == (True, 512, 3584, 18944, 152064)
    assert smoke.train_launches_per_step(cfg) == {
        "rmsnorm": 2 * 12 + 1 + 2 * 12, "flash_attention": 24,
        "flash_attention_backward": 12, "mamba_scan": 0}
    assert smoke.train_launches_per_step(dataclasses.replace(
        cfg, remat=False)) == {"rmsnorm": 25, "flash_attention": 12,
                               "flash_attention_backward": 12,
                               "mamba_scan": 0}
    jamba = serving_config("jamba-v0.1-52b", use_reduced=True)  # 2 x (1:7)
    assert smoke.train_launches_per_step(jamba) == {
        "rmsnorm": 2 * 32 + 1, "flash_attention": 2 * 2,
        "flash_attention_backward": 2, "mamba_scan": 2 * 14}
    layer = 3584 * (28 + 8) * 128 + 28 * 128 * 3584 + 3 * 3584 * 18944
    assert layer == 233_046_016                # + 4,608 bias + 7,168 norm
    mm = 12 * layer + 3584 * 152064
    attn = 3 * 4 * 28 * 128 * (4096 * 4097 // 2) * 12
    assert smoke.train_model_flops(cfg, 1, 4096) == 6 * 4096 * mm + attn
    assert abs(smoke.train_model_flops(cfg, 1, 4096) / 1e12 - 86.45) < 0.01
    def count(t):                   # shape tuples are the leaves here
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        if isinstance(t, list):
            return sum(count(v) for v in t)
        return int(np.prod(t))

    assert 152064 * 3584 == 544_997_376              # embedding, head
    assert count(PM.param_shapes(cfg)) == 3_886_691_840 == (
        12 * 233_057_792 + 2 * 544_997_376 + 3584) == cfg.param_count()
    tree = dict(b=[dict(z=1, a=2)], a=3)
    assert list(smoke._leaf_paths(tree)) == ["a", "b/0/a", "b/0/z"]
    assert T.leaves(tree) == [3, 2, 1]
