"""Where the sharded float8 train step parts from one device's, on the
reduced kimi-k2-1t-a32b config that
``tests/test_torch_moe_fp8.py::test_sharded_fp8_train_step_matches_single_device``
trains (B 8, S 32, AdamW lr 1e-3, warm-up 1; 8 gloo ranks on a (2, 4)
mesh, CPU).

    PYTHONPATH=src python tools/fp8_reanchored_step.py

The mesh runs two steps and returns its whole state after each and each
dispatch's slots (``quantize_slots``' input).  One device then runs step 1
from seed 0 and step 2 from the mesh's state after step 1 (re-anchored),
and step 2 once more with each dispatch's payload and scales taken from
the mesh's slots.  Prints one JSON line a step: the loss and grad norm
differences; for each dispatch, the slots' largest difference in float32
ulps of the slot's largest magnitude, the e4m3 payload elements and
scales that differ, and the largest distance between two quotients that
round otherwise, in ulps of 448; and whether re-placing the mesh's state
on the mesh reproduces its step-2 loss bit for bit.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.mesh import make_local_mesh, run_ranks
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.act import is_sharded
from repro_torch.parallel.ranks import train_batch, whole_leaves
from repro_torch.train.steps import (_replicating, init_train_state,
                                     make_train_step)

OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
B, S, MESH = 8, 32, (2, 4)


def _cfg():
    return dataclasses.replace(reduced(get_config("kimi-k2-1t-a32b")),
                               moe_dispatch_dtype="float8_e4m3fn")


def _load(tree, leaves):
    for i, t in enumerate(T.leaves(tree)):
        t.copy_(torch.from_numpy(leaves[i]))


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, other):
        return other.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def recording_quantize(seen, slots=None):
    """(``quantize_slots``, a stand-in for it that records its input whole
    into ``seen`` and, given ``slots``, returns the payload and scales
    they quantize to, on the gradient path of its own)."""
    quantize, given = MOE.quantize_slots, iter(slots or ())

    def q(xe):
        whole = xe.full_tensor() if is_sharded(xe) else xe
        seen.append(whole.detach().float().numpy().copy())
        out, s = quantize(xe)
        if slots is None:
            return out, s
        q2, s2 = MOE._quantize_local(torch.from_numpy(next(given)))
        return _Rounded.apply(out, q2), s + (s2 - s).detach()
    return quantize, q


def _rank(rank, world):
    cfg = _cfg()
    mesh = make_local_mesh(*MESH, device="cpu")
    p_sh = sh.to_shardings(sh.param_pspecs(cfg, mesh), mesh)
    b_sh = sh.to_shardings(sh.batch_pspecs(
        cfg, ShapeSpec("t", S, B, "train"), mesh), mesh)
    params = sh.device_put(M.init_params(cfg, seed=0, device="cpu"), p_sh)
    opt = adamw_init(params, OPT)
    step = make_train_step(cfg, OPT)
    slots, metrics, states = [], [], []
    for k in range(2):
        seen = []
        quantize, MOE.quantize_slots = recording_quantize(seen)
        try:
            batch = sh.device_put(train_batch(cfg, B, S, "cpu", k), b_sh)
            with sh.activation_mesh(mesh):
                params, opt, m = step(params, opt, batch)
        finally:
            MOE.quantize_slots = quantize
        slots.append(seen)
        metrics.append({n: float(v) for n, v in m.items()})
        states.append((whole_leaves(params), whole_leaves(opt)))
    again = M.init_params(cfg, seed=0, device="cpu")
    _load(again, states[0][0])
    again = sh.device_put(again, p_sh)
    batch = sh.device_put(train_batch(cfg, B, S, "cpu", 1), b_sh)
    with torch.no_grad(), sh.activation_mesh(mesh), _replicating(True):
        _, m = M.loss_fn(again, batch, cfg)
    replaced = float(m["loss"].full_tensor())
    return None if rank else dict(slots=slots, metrics=metrics,
                                  states=states, replaced=replaced)


def one_device_step(cfg, k, state=None, slots=None):
    """One device's train step on data step ``k``, from seed 0's state or
    ``state`` (a ``whole_leaves`` (params, opt) pair).  Returns its
    metrics and each dispatch's slots; with ``slots`` (another run's, in
    call order), each dispatch's payload and scales are those ``slots``
    quantize to, the gradient still through this step's own."""
    params, opt = init_train_state(cfg, OPT, seed=0, device="cpu")
    if state is not None:
        _load(params, state[0])
        _load(opt, state[1])
    seen = []
    quantize, MOE.quantize_slots = recording_quantize(seen, slots)
    try:
        _, _, m = make_train_step(cfg, OPT)(params, opt,
                                            train_batch(cfg, B, S, "cpu", k))
    finally:
        MOE.quantize_slots = quantize
    return {n: float(v) for n, v in m.items()}, seen


def dispatch_change(mine, theirs):
    """Two runs' slots of one dispatch: their largest difference in f32
    ulps of the slot's largest magnitude, the scales' in ulps of the
    scale, the payload elements that round otherwise and the largest
    distance of their two quotients in ulps of 448."""
    a, b = torch.from_numpy(mine), torch.from_numpy(theirs)
    (qa, sa), (qb, sb) = MOE._quantize_local(a), MOE._quantize_local(b)
    sa, sb = sa.numpy(), sb.numpy()
    other = (qa.view(torch.uint8) != qb.view(torch.uint8)).numpy()
    ulp = np.spacing(np.abs(mine).max(-1, keepdims=True))
    tie = np.abs(mine / sa - theirs / sb)[other]
    return dict(slot_ulps_max=float((np.abs(mine - theirs) / ulp).max()),
                scale_ulps_max=float((np.abs(sa - sb) / np.spacing(sa)).max()),
                payload_elements=int(other.size),
                payload_rounded_otherwise=int(other.sum()),
                scales_differing=int((sa != sb).sum()),
                tie_distance_ulps_of_448=float(tie.max() / np.spacing(
                    np.float32(MOE.E4M3_MAX))) if tie.size else None)


def _diff(a, b):
    return dict(loss_change=abs(a["loss"] - b["loss"]),
                grad_norm_change=abs(a["grad_norm"] - b["grad_norm"]))


def main() -> int:
    torch.set_num_threads(4)
    cfg = _cfg()
    mesh = run_ranks(_rank, MESH[0] * MESH[1], device="cpu")[0]
    for k, state in ((0, None), (1, mesh["states"][0])):
        m, seen = one_device_step(cfg, k, state)
        row = dict(step=k + 1, anchored=("seed 0" if state is None
                                         else "the mesh's state"),
                   **_diff(mesh["metrics"][k], m),
                   dispatches=[dispatch_change(a, b) for a, b in
                               zip(seen, mesh["slots"][k], strict=True)])
        if k == 1:
            shared, _ = one_device_step(cfg, k, state, mesh["slots"][k])
            row.update(shared_payload=_diff(mesh["metrics"][k], shared),
                       replaced_on_mesh_bitwise=(
                           mesh["replaced"] == mesh["metrics"][k]["loss"]))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
