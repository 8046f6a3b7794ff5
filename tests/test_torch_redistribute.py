"""``repro_torch.parallel.act.redistribute``: a change of placements over
several mesh axes as one collective over the flattened axes, as the
reference's partitioner issues it (GSPMD's replica groups span the axes
at once; DTensor runs one collective a mesh dim).

* The plan, on a duck-typed mesh: which changes it makes itself (a sum
  over two axes, a gather or a reduce-scatter of one tensor dim over two,
  a slice before a collective) and which it leaves to DTensor (one axis,
  two tensor dims, an uneven dim).
* On 4 gloo CPU ranks at 2 x 2: a ``Partial`` over ('data', 'model')
  reduced, and a ``(Shard(0), Shard(0))`` tensor gathered, by the helper
  and by DTensor's own ``redistribute``: equal values and equal gradients
  of a ``Partial`` gradient, bit for bit (small integers in float64), with
  one collective where DTensor runs two, each way, as the dry run's
  ``Accounting`` counts them; and the same on collectives staged through
  the host (the route of ranks that share one card over gloo).
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_ranks
from repro_torch.parallel.act import _grouped_steps
from repro_torch.parallel.ranks import (grouped_redistribute_rank,
                                        run_jobs, with_host_staging)


class _Mesh:
    """What the plan reads of a mesh: its dims' sizes."""

    def __init__(self, *sizes):
        self.sizes = sizes

    def size(self, i):
        return self.sizes[i]


def _placements(text):
    from torch.distributed.tensor import Partial, Replicate, Shard

    made = {"R": Replicate, "P": Partial}
    return tuple(made[t]() if t in made else Shard(int(t[1]))
                 for t in text.split())


#: (source, target, shape, mesh sizes) -> the plan's steps
PLANS = [
    ("P P", "R R", (4, 6), (2, 2), [("sum", None, [0, 1])]),
    ("P P R", "R R R", (4, 6), (2, 16, 16), [("sum", None, [0, 1])]),
    ("S0 S0", "R R", (4, 6), (2, 2), [("gather", 0, [0, 1])]),
    ("S2 S2 R", "R R R", (4, 6, 8), (2, 2, 4), [("gather", 2, [0, 1])]),
    ("P P", "S0 S0", (4, 6), (2, 2), [("scatter", 0, [0, 1])]),
    ("R R", "S0 S0", (4, 6), (2, 2), [("slice", 0, [0, 1])]),
    ("R P", "S0 R", (4, 6), (2, 2), [("slice", 0, [0]),
                                     ("sum", None, [1])]),
    ("P P P", "R R R", (4, 6), (2, 1, 4), [("sum", None, [0, 1, 2])]),
    # DTensor's own: one axis; one axis of more than one rank; two tensor
    # dims; an uneven dim; a gather of part of a dim's shards
    ("P R", "R R", (4, 6), (2, 2), []),
    ("P P", "R R", (4, 6), (1, 4), []),
    ("S0 S1", "R R", (4, 6), (2, 2), []),
    ("S0 S0", "R R", (6, 6), (4, 4), []),
    ("S0 S0", "R S0", (4, 6), (2, 2), []),
    ("R R", "S0 R", (4, 6), (2, 2), []),
]


@pytest.mark.parametrize("src,dst,shape,sizes,want", PLANS)
def test_the_plan_groups_what_spans_two_mesh_axes(src, dst, shape, sizes,
                                                  want):
    got = _grouped_steps(_placements(src), _placements(dst), shape,
                         _Mesh(*sizes))
    assert got == want


@pytest.fixture(scope="module")
def launched():
    """One launch of 4 gloo CPU ranks at 2 x 2: the cases counted, then
    the same with the collectives staged through the host (installed for
    the rest of the launch, so it runs last)."""
    return run_ranks(run_jobs, 4, [
        (grouped_redistribute_rank, ((2, 2), "cpu")),
        (with_host_staging, ("cpu", grouped_redistribute_rank,
                             ((2, 2), "cpu", False)))], device="cpu")


@pytest.fixture(scope="module")
def ranks(launched):
    return [got[0] for got in launched]


#: per case: (the collective kind each way, forward and backward)
KINDS = {"sum": ("all-reduce", None), "gather": ("all-gather",
                                                 "reduce-scatter")}


@pytest.mark.parametrize("case", sorted(KINDS))
def test_one_collective_over_both_axes_equals_dtensors_two(ranks, case):
    """Each rank's result and gradient equal DTensor's exactly, in the same
    placements; the helper's forward runs one collective over both axes
    (``@data+model``), DTensor's two, one an axis; a gather's backward is
    one reduce-scatter against two; a sum's backward keeps its
    ``Partial`` gradient and moves nothing either way."""
    fwd, bwd = KINDS[case]
    for got in ranks:
        mine, theirs = got[case, "grouped"], got[case, "dtensor"]
        assert np.array_equal(mine["y"], theirs["y"])
        assert np.array_equal(mine["grad"], theirs["grad"])
        assert mine["placements"] == theirs["placements"] == [
            "Replicate", "Replicate"]
        assert mine["grad_placements"] == theirs["grad_placements"]
        assert mine["forward"] == {fwd: 1} and theirs["forward"] == {fwd: 2}
        assert mine["flattened"] == {fwd: 1} and theirs["flattened"] == {}
        assert mine["backward"] == ({bwd: 1} if bwd else {})
        assert theirs["backward"] == ({bwd: 2} if bwd else {})
        assert all(r.endswith(" @data+model") for r in mine["rows"])
        assert sorted(r.rsplit("@", 1)[1] for r in theirs["rows"]) == sorted(
            ["data", "model"] * (2 if bwd else 1))


@pytest.mark.parametrize("case", sorted(KINDS))
def test_the_staged_route_gives_the_same_bits(launched, case):
    """Through the host-staged collectives (what the one-card rig runs):
    each rank's result and gradient by either path equal the unstaged
    ones bit for bit, and the staging carried the exchanges."""
    for got in launched:
        (staged, moved), plain = got[1], got[0]
        for path in ("grouped", "dtensor"):
            assert np.array_equal(staged[case, path]["y"],
                                  plain[case, path]["y"])
            assert np.array_equal(staged[case, path]["grad"],
                                  plain[case, path]["grad"])
        assert moved["calls"] > 0
