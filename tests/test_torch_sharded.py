"""Sharded execution on DTensor (``repro_torch.parallel``,
``repro_torch.launch.mesh``) on eight CPU ranks: the reference's own
checks, run in one launch of ``run_ranks`` (gloo, one torch thread a rank).

* The sharded train step on the reference test's (2, 4) mesh for all five
  configs of ``tests/test_sharded_execution.py`` (``reduced(get_config(
  arch))``, B 8, S 32): parameters, AdamW state and batch placed by the
  rules, the step inside ``activation_mesh``, two steps held to the port's
  single-device steps at the reference test's tolerances (loss within
  2e-3, grad norm within 2e-2 relative), and beyond them each leaf's step-1
  gradient within LEAF_REL_TOL relative L2, and the parameters after the
  two steps (the sharded AdamW update) within LEAF_REL_TOL of AdamW run on
  one device on the mesh's own gradients.  The single-device step is
  itself held to the reference's by ``test_torch_train.py``.
* ``ep_moe_forward`` on a (2, 4) mesh with the reference's ``EP_SCRIPT``
  shapes, inputs drawn from a numpy seed and fed to both: within 1e-4 of
  the reference's ``ep_moe_forward`` (run in a subprocess with 8 XLA host
  devices, as ``tests/test_lifts_ep.py`` runs it) and of both packages'
  single-device ``moe_forward``; at capacity factor 8 (nothing dropped)
  and 1.25 (assignments dropped: the same ones, the dispatch tables equal).
* A dim sharded over ('pod', 'data') on a (2, 2, 2) mesh: each rank's
  shard against the hand-computed slice.
* The uneven-heads repair: 12 query and 4 kv heads on a 1 x 8 mesh, two
  steps against the single-device steps (loss and grad norm within 1e-6).
* The host staging of DTensor's collectives that ranks sharing one card
  over gloo run (``launch.mesh.stage_collectives_through_host``), forced
  on the CPU: the same step; it refuses a torch that lacks a name it
  replaces.
"""
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.moe import _route_group, capacity, moe_forward
from repro_torch import tree as T
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.parallel.ranks import (ep_moe_rank, local_shards, run_jobs,
                                        sharded_train_steps, train_batch,
                                        whole_leaves, with_host_staging)
from repro_torch.train.steps import init_train_state, make_train_step
from test_torch_harness import ROOT

ARCHS = ["qwen2-7b", "jamba-v0.1-52b", "kimi-k2-1t-a32b", "falcon-mamba-7b",
         "gemma3-12b"]
B, S = 8, 32
MESH = (2, 4)
RANKS = 8
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
STEPS = 2
#: the reference test's tolerances
LOSS_TOL, GNORM_REL_TOL = 2e-3, 2e-2
#: each leaf's gradient, relative L2 (float32 on the host): the mesh only
#: reorders f32 sums (split contractions, partial sums reduced across
#: ranks), ~1e-6 relative, so 1e-4 leaves a hundredfold margin; a leaf that
#: loses a shard's share of its gradient (a missing partial-sum reduction)
#: is off by O(1).  The parameters after the steps are held to AdamW on
#: the mesh's own gradients at the same bound (only the global norm's
#: summation order differs): against the single-device steps they part
#: further, where a gradient element near AdamW's eps amplifies a 1e-7
#: difference (zero-initialised biases, 1e-3 relative L2)
LEAF_REL_TOL = 1e-4
EP_TOL = 1e-4
EP_CFS = (8.0, 1.25)
#: the uneven-heads repair: 12 query and 4 kv heads on an 8-wide model
#: axis (1 x 8), neither dividing it
UNEVEN_MESH = (1, 8)
#: loss and grad norm: the mesh only reorders f32 sums, ~1e-7; each leaf's
#: gradient is held at LEAF_REL_TOL as for the other configs (the worst
#: leaf measured 1.04e-6, a bias gradient: a sum of B * S f32 terms
#: reordered, relative to its own small norm)
UNEVEN_TOL = 1e-6
#: the two-axis placement: (pod, data, model) = (2, 2, 2)
POD_MESH = ((2, 2, 2), ("pod", "data", "model"))
POD_SPEC = (("pod", "data"), None, "model")

#: the reference's EP forward and single-device MoE on EP_SCRIPT's shapes,
#: in a subprocess with 8 XLA host devices (tests/test_lifts_ep.py), for
#: each capacity factor, with its per-group dispatch tables
EP_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models.moe import capacity, moe_forward
from repro.parallel.ep_moe import _route_local, ep_moe_forward

d = np.load(sys.argv[1])
params = {k: jnp.asarray(d[k]) for k in ("router", "wg", "wu", "wd")}
x = jnp.asarray(d["x"])
mesh = jax.make_mesh((2, 4), ("data", "model"))
xs = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
ps = dict(router=jax.device_put(params["router"], NamedSharding(mesh, P())),
          **{n: jax.device_put(params[n], NamedSharding(
              mesh, P("model", None, None))) for n in ("wg", "wu", "wd")})
out = {}
for i, cf in enumerate(d["cfs"]):
    class Cfg:
        d_model = 32; n_experts = 8; experts_per_token = 2; moe_d_ff = 16
        capacity_factor = float(cf); mlp_act = "silu"
        moe_dispatch_dtype = "bfloat16"
    y_moe, _ = moe_forward(params, x, Cfg)
    y_ep = ep_moe_forward(mesh, ps, xs, Cfg)
    C = capacity(x.shape[1], 8, 2, Cfg.capacity_factor)
    _, disp, _ = jax.vmap(lambda xg: _route_local(
        xg, params["router"], 2, C, 8))(x)
    out[f"y_moe{i}"] = np.asarray(y_moe)
    out[f"y_ep{i}"] = np.asarray(y_ep)
    out[f"dispatch{i}"] = np.asarray(disp)
np.savez(sys.argv[2], **out)
"""


def _uneven_cfg():
    return dataclasses.replace(reduced(get_config("qwen2-7b")), n_heads=12,
                               n_kv_heads=4, name="qwen2-7b-reduced-h12")


def _padded_cfg():
    """qwen2-7b-shaped heads that do not divide MESH's model axis of 4: 6
    query heads in 3 kv groups (G 2), as qwen2-7b's 28 / 4 at 16."""
    return dataclasses.replace(reduced(get_config("qwen2-7b")), n_heads=6,
                               n_kv_heads=3, name="qwen2-7b-reduced-h6")


def _kv_group_cfg():
    """Query heads that do not divide MESH's model axis of 4 and kv heads
    that do: 6 query heads in 2 kv groups (G 3), each kv group's heads on 2
    ranks, as qwen2-7b's 28 / 4 on 4 groups of 4 at 16."""
    return dataclasses.replace(reduced(get_config("qwen2-7b")), n_heads=6,
                               n_kv_heads=2, name="qwen2-7b-reduced-h6-kv2")


def _table_cfg():
    """Reduced qwen2-7b with a vocabulary of 212 rows (the reduced 211 does
    not split over a model axis), on POD_MESH: the batch on ('pod',
    'data'), the table's rows on 'model' and its D on 'data' alone, so the
    embedding moves the table (``act._TableToColumns``)."""
    return dataclasses.replace(reduced(get_config("qwen2-7b")),
                               vocab_size=212, name="qwen2-7b-reduced-v212")


def _ep_cfg(cf: float):
    return types.SimpleNamespace(
        d_model=32, n_experts=8, experts_per_token=2, moe_d_ff=16,
        capacity_factor=cf, mlp_act="silu", moe_dispatch_dtype="bfloat16")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ep_inputs():
    """EP_SCRIPT's shapes (router (32, 8), experts (8, 32, 16) / (8, 16,
    32) at scale 0.1, x (4, 24, 32)), drawn from numpy seed 0."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    return dict(router=(rng.standard_normal((32, 8)) * 0.1).astype(f32),
                wg=(rng.standard_normal((8, 32, 16)) * 0.1).astype(f32),
                wu=(rng.standard_normal((8, 32, 16)) * 0.1).astype(f32),
                wd=(rng.standard_normal((8, 16, 32)) * 0.1).astype(f32),
                x=rng.standard_normal((4, 24, 32)).astype(f32))


@pytest.fixture(scope="module")
def pod_array():
    return np.arange(8 * 3 * 4, dtype=np.float32).reshape(8, 3, 4)


@pytest.fixture(scope="module")
def runs(ep_inputs, pod_array, tmp_path_factory):
    """The reference's EP forward in its subprocess, started first and
    left running while one launch of eight ranks runs the sharded steps of
    the five configs, the EP forward at both capacity factors and the
    two-axis placement.  Returns (per-rank results, reference arrays)."""
    tmp = tmp_path_factory.mktemp("ep_ref")
    np.savez(tmp / "in.npz", cfs=np.array(EP_CFS), **ep_inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", EP_REF,
                             str(tmp / "in.npz"), str(tmp / "out.npz")],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        cfgs = [reduced(get_config(a)) for a in ARCHS]
        jobs = [(sharded_train_steps, (cfgs, OPT, B, S, MESH, "cpu", STEPS,
                                       None)),
                *[(ep_moe_rank, (ep_inputs, _ep_cfg(cf), MESH, "cpu"))
                  for cf in EP_CFS],
                (local_shards, (*POD_MESH, [pod_array], [POD_SPEC])),
                (sharded_train_steps, ([_uneven_cfg()], OPT, B, S,
                                       UNEVEN_MESH, "cpu", STEPS, None)),
                (sharded_train_steps, ([_padded_cfg()], OPT, B, S, MESH,
                                       "cpu", STEPS, None)),
                (sharded_train_steps, ([_kv_group_cfg()], OPT, B, S, MESH,
                                       "cpu", STEPS, None)),
                (sharded_train_steps, ([_table_cfg()], OPT, B, S,
                                       POD_MESH[0], "cpu", STEPS, None)),
                # last: the host staging of ranks on one card, here on
                # the CPU
                (with_host_staging, ("cpu", sharded_train_steps,
                                     (cfgs[:1], OPT, B, S, MESH, "cpu")))]
        ranks = run_ranks(run_jobs, RANKS, jobs, device="cpu")
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return ranks, dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def launched(runs):
    return runs[0]


@pytest.fixture(scope="module")
def ep_reference(runs):
    return runs[1]


def _rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_single_device(launched, arch):
    """The reference's test, for all five configs: the port's steps on the
    (2, 4) mesh against its single-device steps from the same state --
    both steps' loss and grad norm, step 1's gradient and the parameters
    after the steps leaf by leaf."""
    i = ARCHS.index(arch)
    cfg = reduced(get_config(arch))
    params, opt = init_train_state(cfg, OPT, seed=0, device="cpu")
    grads = []
    step = make_train_step(cfg, OPT, on_grads=lambda g: grads.append(
        whole_leaves(g)))
    want = []
    for k in range(STEPS):
        params, opt, m = step(params, opt, train_batch(cfg, B, S, "cpu", k))
        want.append({n: float(v) for n, v in m.items()})
    rows = [r[0][i] for r in launched]
    for r in rows:                      # every rank reads the same metrics
        assert r["arch"] == cfg.name
        assert r["metrics"] == rows[0]["metrics"]
    for got, one in zip(rows[0]["metrics"], want, strict=True):
        assert abs(got["loss"] - one["loss"]) < LOSS_TOL, (got, one)
        assert abs(got["grad_norm"] - one["grad_norm"]) / max(
            one["grad_norm"], 1) < GNORM_REL_TOL, (got, one)
    # step 1's gradients leaf by leaf
    mine, single = rows[0]["grads"][0], grads[0]
    assert sorted(mine) == sorted(single)
    worst = max((_rel_l2(mine[j], single[j]), j) for j in single)
    assert worst[0] < LEAF_REL_TOL, worst
    # the sharded update: AdamW on one device from the same initial state,
    # fed the mesh's own gradients, gives the mesh's parameters
    params, opt = init_train_state(cfg, OPT, seed=0, device="cpu")
    flat, treedef = T.flatten(params)
    for g in rows[0]["grads"]:
        params, opt, _ = adamw_update(params, T.unflatten(treedef, [
            torch.from_numpy(g[j]).to(p.dtype) for j, p in enumerate(flat)]),
            opt, OPT)
    replay, after = whole_leaves(params), rows[0]["params_after"]
    assert sorted(after) == sorted(replay)
    worst = max((_rel_l2(after[j], replay[j]), j) for j in replay)
    assert worst[0] < LEAF_REL_TOL, worst
    # the mesh really divided the state: each rank holds less than all
    assert all(r["local_param_elements"] < r["param_elements"] for r in rows)


@pytest.mark.parametrize("case", range(len(EP_CFS)))
def test_ep_moe_matches_reference_and_single_device(launched, ep_reference,
                                                    ep_inputs, case):
    cf = EP_CFS[case]
    rows = [r[1 + case] for r in launched]
    y, dispatch = rows[0]["y"], rows[0]["dispatch"]
    for r in rows:            # exactly two exchanges: dispatch and return
        assert r["all_to_all"] == 2
    # against the reference's EP forward and single-device MoE
    assert np.abs(y - ep_reference[f"y_ep{case}"]).max() < EP_TOL
    assert np.abs(y - ep_reference[f"y_moe{case}"]).max() < EP_TOL
    # against the port's single-device MoE
    cfg = _ep_cfg(cf)
    tp = {k: torch.from_numpy(v) for k, v in ep_inputs.items()}
    x = tp.pop("x")
    y_one, _ = moe_forward(tp, x, cfg)
    assert np.abs(y - y_one.numpy()).max() < EP_TOL
    # the same slots, so the same dropped assignments
    G, Sg, _ = x.shape
    C = capacity(Sg, 8, 2, cf)
    mine = _route_group(x @ tp["router"], 2, C, 8)[0].numpy()
    np.testing.assert_array_equal(dispatch, mine.reshape(G, 8, C))
    np.testing.assert_array_equal(dispatch, ep_reference[f"dispatch{case}"]
                                  .reshape(G, 8, C))
    kept = int(np.sum(dispatch < Sg * 2))
    if cf == 8.0:
        assert kept == G * Sg * 2
    else:
        assert kept < G * Sg * 2, "capacity 1.25 should drop assignments"


def test_uneven_heads_step_matches_single_device(launched):
    """12 query heads and 4 kv heads on an 8-wide model axis (1 x 8): the
    sharded backward gathers the uneven heads where it flattens them (it
    raised there before), and two steps equal the single-device steps:
    loss and grad norm within UNEVEN_TOL, step 1's gradient leaf by leaf
    within LEAF_REL_TOL."""
    cfg = _uneven_cfg()
    params, opt = init_train_state(cfg, OPT, seed=0, device="cpu")
    grads = []
    step = make_train_step(cfg, OPT, on_grads=lambda g: grads.append(
        whole_leaves(g)))
    want = []
    for k in range(STEPS):
        params, opt, m = step(params, opt, train_batch(cfg, B, S, "cpu", k))
        want.append({n: float(v) for n, v in m.items()})
    rows = [r[4][0] for r in launched]
    for r in rows:
        assert r["arch"] == cfg.name
        assert r["metrics"] == rows[0]["metrics"]
    for got, one in zip(rows[0]["metrics"], want, strict=True):
        assert abs(got["loss"] - one["loss"]) < UNEVEN_TOL, (got, one)
        assert abs(got["grad_norm"] - one["grad_norm"]) < UNEVEN_TOL * max(
            one["grad_norm"], 1), (got, one)
    mine, single = rows[0]["grads"][0], grads[0]
    assert sorted(mine) == sorted(single)
    worst = max((_rel_l2(mine[j], single[j]), j) for j in single)
    assert worst[0] < LEAF_REL_TOL, worst


def test_padded_heads_step_matches_single_device(launched):
    """6 query heads in 3 kv groups on MESH's model axis of 4, in the
    reference partitioner's padded layout (ranks 0-2 one kv group each,
    rank 3 a zero group): two steps equal the single-device steps, loss
    and grad norm within UNEVEN_TOL, step 1's gradient of every leaf within
    LEAF_REL_TOL."""
    cfg = _padded_cfg()
    params, opt = init_train_state(cfg, OPT, seed=0, device="cpu")
    grads = []
    step = make_train_step(cfg, OPT, on_grads=lambda g: grads.append(
        whole_leaves(g)))
    want = []
    for k in range(STEPS):
        params, opt, m = step(params, opt, train_batch(cfg, B, S, "cpu", k))
        want.append({n: float(v) for n, v in m.items()})
    rows = [r[5][0] for r in launched]
    for r in rows:
        assert r["arch"] == cfg.name
        assert r["metrics"] == rows[0]["metrics"]
    for got, one in zip(rows[0]["metrics"], want, strict=True):
        assert abs(got["loss"] - one["loss"]) < UNEVEN_TOL, (got, one)
        assert abs(got["grad_norm"] - one["grad_norm"]) < UNEVEN_TOL * max(
            one["grad_norm"], 1), (got, one)
    mine, single = rows[0]["grads"][0], grads[0]
    assert sorted(mine) == sorted(single)
    worst = max((_rel_l2(mine[j], single[j]), j) for j in single)
    assert worst[0] < LEAF_REL_TOL, worst


def _held_to_single(launched, job: int, cfg):
    """The job's two steps of ``cfg`` on its mesh against the single-device
    steps: loss and grad norm within UNEVEN_TOL, step 1's gradient of every
    leaf within LEAF_REL_TOL."""
    params, opt = init_train_state(cfg, OPT, seed=0, device="cpu")
    grads = []
    step = make_train_step(cfg, OPT, on_grads=lambda g: grads.append(
        whole_leaves(g)))
    want = []
    for k in range(STEPS):
        params, opt, m = step(params, opt, train_batch(cfg, B, S, "cpu", k))
        want.append({n: float(v) for n, v in m.items()})
    rows = [r[job][0] for r in launched]
    for r in rows:
        assert r["arch"] == cfg.name
        assert r["metrics"] == rows[0]["metrics"]
    for got, one in zip(rows[0]["metrics"], want, strict=True):
        assert abs(got["loss"] - one["loss"]) < UNEVEN_TOL, (got, one)
        assert abs(got["grad_norm"] - one["grad_norm"]) < UNEVEN_TOL * max(
            one["grad_norm"], 1), (got, one)
    mine, single = rows[0]["grads"][0], grads[0]
    assert sorted(mine) == sorted(single)
    worst = max((_rel_l2(mine[j], single[j]), j) for j in single)
    assert worst[0] < LEAF_REL_TOL, worst


def test_kv_group_heads_step_matches_single_device(launched):
    """6 query heads in 2 kv groups on MESH's model axis of 4: each rank
    computes its kv group's attention and keeps its own columns of the
    output, those of wo's row shard (``transformer._kv_group_attention``,
    the reference partitioner's layout for qwen2-7b at 16); its two steps
    equal the single-device steps."""
    cfg = _kv_group_cfg()
    M = MESH[1]
    assert cfg.n_heads % M and M % cfg.n_kv_heads == 0
    _held_to_single(launched, 6, cfg)


def test_table_moving_embedding_step_matches_single_device(launched):
    """On POD_MESH, where the batch lies on ('pod', 'data') and the table's
    D on 'data' alone, the embedding moves the table (a permute over
    'data' and 'model', its rows gathered over 'data'; the gradient summed
    over ('pod', 'data') and permuted back): two steps equal the
    single-device steps, the embedding's gradient among the leaves.  The
    fake trace of the same step shows the permute."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as D

    cfg = _table_cfg()
    _held_to_single(launched, 7, cfg)
    _, rows = D.trace_step(cfg, ShapeSpec("t", S, B, "train"),
                           dict(zip(POD_MESH[1], POD_MESH[0])), device="cpu")
    assert [r for r in rows if r[2] == 0 and "all_to_all_single" in r[0]
            and r[0].endswith(" @data+model")]


def test_two_axis_dim_takes_the_hand_computed_shard(launched, pod_array):
    """P(('pod', 'data'), None, 'model') on (pod 2, data 2, model 2): rank
    r = (pod, data, model) in row-major order holds rows [2 (2 pod + data),
    2 (2 pod + data) + 2) and columns [2 model, 2 model + 2)."""
    for r, res in enumerate(launched):
        pod, data, model = r // 4, (r // 2) % 2, r % 2
        b = 2 * pod + data
        want = pod_array[2 * b:2 * b + 2, :, 2 * model:2 * model + 2]
        np.testing.assert_array_equal(res[3][0], want)


def test_host_staged_collectives_give_the_same_step(launched):
    """The staging of DTensor's collectives through the host (what ranks
    sharing one card over gloo run, where gloo's CUDA path fails DTensor),
    run on the CPU: qwen2-7b's sharded step equal to the unstaged one,
    bytes counted."""
    for r in launched:
        (staged,), moved = r[-1]
        assert staged["metrics"] == r[0][0]["metrics"][:1]
        assert moved["calls"] > 0 and moved["bytes"] > 0


def test_host_staging_refuses_a_torch_without_a_name_it_replaces(
        monkeypatch):
    """The staging replaces torch's private collective functions by name;
    where one is missing it raises instead of leaving that path unstaged,
    and replaces nothing."""
    import torch.distributed.tensor._collective_utils as cu

    from repro_torch.launch import mesh

    monkeypatch.setattr(mesh, "_REPLACED", [])
    monkeypatch.setattr(mesh, "_STAGE_DEVICES", set())
    monkeypatch.delattr(cu, "shard_dim_alltoall")
    with pytest.raises(RuntimeError, match="shard_dim_alltoall"):
        mesh.stage_collectives_through_host(("cpu",))
    assert mesh._REPLACED == []


def test_run_ranks_returns_in_rank_order_and_raises_with_the_traceback():
    """Any importable function runs; a rank's exception comes back with its
    traceback."""
    import math
    import operator

    assert run_ranks(operator.truediv, 2, device="cpu") == [0.0, 0.5]
    with pytest.raises(RuntimeError, match="math domain error"):
        run_ranks(math.log, 2, device="cpu")         # log(0, 2) on rank 0


def _fails_on_rank_one(rank, world):
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank one's own fault")
    dist.all_reduce(torch.ones(1))              # its peer has left


def test_run_ranks_names_the_rank_at_fault_not_its_peers():
    """A rank that fails leaves its peers failing in gloo's transport
    (the connection closed); the error raised is the failing rank's."""
    with pytest.raises(RuntimeError, match="rank 1 of 2") as err:
        run_ranks(_fails_on_rank_one, 2, device="cpu")
    assert "rank one's own fault" in str(err.value)


def _timed_turn(rank, world):
    import time

    from repro_torch.parallel.ranks import _in_turn

    def make():
        t0 = time.monotonic()
        time.sleep(0.2)
        return t0, time.monotonic()
    # the card's path (ranks sharing one card take turns); on a CPU-only
    # torch its release of cached device memory does nothing
    return _in_turn(rank, world, torch.device("cuda"), make)


def test_ranks_sharing_a_card_place_their_parameters_in_turn():
    """``sharded_train_steps``' placement on a card runs on one rank at a
    time, in rank order."""
    spans = run_ranks(_timed_turn, 3, device="cpu")
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert end <= start, spans
