"""The sharded lowering's one-collective sums, Mamba's halves exchange and
the kv-whole attention on real gloo CPU ranks, at reduced widths.

* One train step of reduced ``falcon-mamba-7b`` and of reduced
  ``gemma-2b`` (8 query heads, 1 kv head) at data 1 x model 4, and of
  reduced ``falcon-mamba-7b`` at pod 2 x data 2 x model 1, placed by the
  rules: the loss, the gradient norm and the small leaves' gradients
  against the single-device step, and what each rank's ``Accounting``
  counts against the fake trace of the same step: collectives by kind,
  their bytes, and those over several mesh axes at once.  In_proj's
  halves move by the reference's four permutes a pass (2 w, w, w, w
  columns; w back for each in the backward) and are never gathered
  whole; q
  never moves where only the kv heads miss the axis; no change over
  ('pod', 'data') runs one collective an axis.
* The DTensor MoE layer at pod 2 x data 2 x model 2 on 8 ranks, where the
  combine sums over 'model' and then over ('pod', 'data') at once: its
  output and dispatch table against the single-device layer.
* ``Accounting`` counts the port's own lowering: DTensor's own merging of
  per-axis collectives (torch 2.13 has it, 2.11 not) is off inside it.
* Mamba's split refuses a model axis it cannot split (odd, or not
  dividing d_inner) instead of gathering the product whole.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeSpec, get_config, reduced
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import run_ranks
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.parallel.ranks import (moe_forward_rank, moe_inputs,
                                        run_jobs, sharded_train_steps,
                                        train_batch, whole_leaves)

B, S = 4, 32
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10)
#: the small leaves whose gradients are compared (every leaf here)
LEAVES = 1 << 20
#: f32 throughout: the mesh only reorders sums of f32 partials
REL_TOL = 1e-5
MOE_MESH, MOE_G, MOE_S = (2, 2, 2), 8, 16


def _cfgs():
    fm = reduced(get_config("falcon-mamba-7b"))
    # 8 query heads so that a rank's 2 are told apart from the 1 kv head
    gm = dataclasses.replace(reduced(get_config("gemma-2b")), n_heads=8)
    return fm, gm


#: (config index, mesh) of each step
CASES = [(0, (1, 4)), (1, (1, 4)), (0, (2, 2, 1))]


def _single(cfg):
    from repro_torch.models.model import init_params
    from repro_torch.train.steps import make_train_step

    params = init_params(cfg, seed=0, device="cpu")
    grads = []
    opt = AdamWConfig(**OPT)
    step = make_train_step(cfg, opt, on_grads=lambda g: grads.append(
        whole_leaves(g, LEAVES)))
    _, _, m = step(params, adamw_init(params, opt),
                   train_batch(cfg, B, S, "cpu", 0))
    return {k: float(v) for k, v in m.items()}, grads[0]


@pytest.fixture(scope="module")
def launched():
    """One launch of 4 CPU ranks: the three steps, each counted."""
    fm, gm = _cfgs()
    opt = AdamWConfig(**OPT)
    ranks = run_ranks(run_jobs, 4, [
        (sharded_train_steps, ([fm, gm], opt, B, S, (1, 4), "cpu", 1,
                               LEAVES, True)),
        (sharded_train_steps, ([fm], opt, B, S, (2, 2, 1), "cpu", 1,
                               LEAVES, True))], device="cpu")
    return [[r[0][0] for r in ranks], [r[0][1] for r in ranks],
            [r[1][0] for r in ranks]]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_rank_step_matches_one_device(launched, case):
    """The step's metrics, equal on every rank, and rank 0's whole small
    leaves' gradients against the single-device step, within REL_TOL."""
    which, _ = CASES[case]
    cfg = _cfgs()[which]
    ranks = launched[case]
    metrics, grads = _single(cfg)
    for r in ranks:
        assert r["metrics"] == ranks[0]["metrics"]
    got = ranks[0]["metrics"][0]
    for k in ("loss", "grad_norm"):
        assert abs(got[k] / metrics[k] - 1) <= REL_TOL, (k, got, metrics)
    mine = ranks[0]["grads"][0]
    assert sorted(mine) == sorted(grads) and grads
    for j in grads:
        a, b = mine[j].astype(np.float64), grads[j].astype(np.float64)
        assert np.linalg.norm(a - b) <= REL_TOL * np.linalg.norm(b) + 1e-12


def _per_axis_pairs(rows, axes=("pod", "data")) -> list:
    colls = [op.rsplit(" @", 1) for op, _ in rows]
    return [(a, b) for a, b in zip(colls, colls[1:])
            if len(a) == len(b) == 2 and a[0] == b[0]
            and {a[1], b[1]} == set(axes)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_rank_counts_equal_the_fake_trace(launched, case):
    """What each rank counts equals the fake trace of the same step on the
    same mesh: collectives by kind in calls and bytes, and those over
    several mesh axes at once; and the lowering's own facts on rank 0's
    rows."""
    which, mesh = CASES[case]
    cfg = _cfgs()[which]
    names = ("pod", "data", "model")[-len(mesh):]
    pred, pred_rows = D.trace_step(cfg, ShapeSpec("t", S, B, "train"),
                                   dict(zip(names, mesh)), device="cpu")
    flat = sum(v["count"] for k, v in D.collective_axes(pred_rows).items()
               if "+" in k)
    for r in launched[case]:
        acc = r["accounting"]
        assert acc["collective_counts"] == pred["collectives"][
            "count_by_kind"]
        assert acc["collective_bytes"] == pred["collectives"]["bytes_by_kind"]
        assert sum(acc["flattened_counts"].values()) == flat
    rows = launched[case][0]["collectives"]
    M = mesh[-1]
    if cfg.name.startswith("falcon-mamba") and M > 1:
        w = cfg.d_inner // M
        # the reference's four permutes a pass (its 2 w columns whole,
        # then w, w, w), in the forward and its recompute, and w columns
        # back for each in the backward
        halves = sorted(tuple(c[1][0]) for c in rows
                        if "all_to_all_single" in c[0])
        assert halves == sorted(([(B, S, 2 * w)] * 2 + [(B, S, w)] * 10)
                                * cfg.n_layers)
        assert not [c for c in rows if "all_gather" in c[0]
                    and tuple(c[1][0]) == (B, S, 2 * w)]
    if cfg.name.startswith("gemma"):
        heads = [c[1][0][2] for c in rows if len(c[1][0]) == 4]
        assert heads and set(heads) == {cfg.n_kv_heads}, heads
    if len(mesh) == 3:
        assert flat > 0 and not _per_axis_pairs(rows)


def test_moe_combine_over_pod_and_data_matches_one_device():
    """The DTensor MoE layer (reduced jamba) at pod 2 x data 2 x model 2
    on 8 ranks: output within REL_TOL of the single-device layer's, the
    dispatch table equal."""
    from repro_torch.models.moe import moe_forward

    cfg = reduced(get_config("jamba-v0.1-52b"))
    inputs = moe_inputs(cfg, MOE_G, MOE_S, 0, "cpu")
    x = inputs.pop("x")
    with torch.no_grad():
        want, _, dispatch = moe_forward(inputs, x, cfg, return_dispatch=True)
    got = run_ranks(moe_forward_rank, 8, dict(seed=0, G=MOE_G, S=MOE_S), cfg,
                    MOE_MESH, "cpu", device="cpu")[0]["bfloat16"]
    assert np.array_equal(got["dispatch"], dispatch.numpy())
    y = want.float().numpy()
    assert np.linalg.norm(got["y"] - y) <= REL_TOL * np.linalg.norm(y)


def test_accounting_counts_the_ports_own_lowering():
    """Inside ``Accounting`` DTensor's own merging of per-axis collectives
    is off (where this torch has it), and as it was after."""
    import torch.distributed.tensor._redistribute as rd

    flag = "_DISABLE_REDISTRIBUTE_TRANSFORM_OPTIMIZATION"
    if not hasattr(rd, flag):
        pytest.skip("this torch's DTensor does not merge collectives")
    before = getattr(rd, flag)
    with D.Accounting("cpu"):
        assert getattr(rd, flag) is True
    assert getattr(rd, flag) == before


@pytest.mark.parametrize("M,Di", [(3, 12), (4, 6)])
def test_mamba_split_refuses_a_model_axis_it_cannot_split(M, Di):
    """An odd model axis, or one that does not divide d_inner: a clear
    error, not a second lowering."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models.mamba import _split_in_proj

    with D.fake_world(M):
        mesh = init_device_mesh("cpu", (1, M),
                                mesh_dim_names=("data", "model"))
        xz = DTensor.from_local(torch.zeros(2, 4, 2 * Di // M), mesh,
                                [Replicate(), Shard(2)])
        with pytest.raises(ValueError, match="d_inner"):
            _split_in_proj(xz, Di)
