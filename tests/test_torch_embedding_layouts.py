"""The embedding lookup's row-gather layout in the dry run, and the rank
launchers' default device.

* The fake-world trace of ``models.model._embed_in``'s lookup alone and
  its backward (``launch.dryrun.Accounting`` over 256 or 512 fake ranks),
  at the three points where the reference's partitioner gathers the
  table's whole rows over 'model' (16 x 16, 8 x 8 and 2 x 16 x 16), holds
  the same collectives as the reference's compiled HLO of the same lookup
  (``tools/embedding_layouts.py --collectives``, a subprocess with 512 XLA
  host devices), in the same order: kind, the mesh axes each group spans
  and elements a device within ELEMENTS_REL (``act.permute``'s all-to-all
  over ('data', 'model') stands for XLA's collective-permute; the loss's
  own scalar sum is left out).
* ``chip_smoke.py``'s lookup cases read the layouts it expects from the
  reference, and its list of the row-gather layout's collectives
  (``row_gather_collectives``, which the card's ranks are held to) is the
  reference's at its S 2000 case.
* ``launch.mesh.make_local_mesh`` and ``run_ranks`` default to the card
  and raise without one before starting a rank.
"""
import importlib.util
import inspect
import types

import numpy as np
import pytest
import torch

from test_torch_harness import ROOT, load_chip_smoke
from test_torch_lowering_faults import (ROW_GATHER_POINTS, _port_kinds,
                                        _reference_kinds)

#: elements a device within this of the reference's, collective by
#: collective (measured equal)
ELEMENTS_REL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke_points(smoke) -> list:
    """chip_smoke.py's lookup cases as the tool's points."""
    from repro_torch.serve import serving_config

    cfg = serving_config(smoke.TABLE_MOVE_ARCH, layers=1)
    batch = int(np.prod(smoke.TABLE_MOVE_MESH[:-1]))
    return [[cfg.vocab_size, cfg.d_model, smoke.TABLE_MOVE_BATCH // batch,
             S, list(smoke.TABLE_MOVE_MESH)]
            for _, S in smoke.TABLE_MOVE_CASES]


@pytest.fixture(scope="module")
def reference_rows():
    """The reference's collectives at each ROW_GATHER_POINT, then at each
    of chip_smoke.py's lookup cases."""
    spec = importlib.util.spec_from_file_location(
        "embedding_layouts", ROOT / "tools" / "embedding_layouts.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.read(ROW_GATHER_POINTS + _smoke_points(load_chip_smoke()),
                     collectives=True)


def trace_lookup(V: int, D: int, Bl: int, S: int, mesh_shape) -> list:
    """The collectives one rank of a fake world runs for the lookup of a
    (V, D) float32 table placed as the rules place ``embed`` (rows on
    'model', D on 'data') at (B, S) tokens on the batch axes, B = ``Bl``
    a batch rank, and the gradient of ``sum(x * c)`` with c (B, S, D) on
    the batch axes: (op with the axes its group spans, operand shapes,
    elements), as ``Accounting`` rows them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun as DR
    from repro_torch.models.model import _embed_in
    from repro_torch.parallel import sharding as sh

    names = ("pod", "data", "model")[-len(mesh_shape):]
    shape = dict(zip(names, mesh_shape))
    B = Bl * int(np.prod(mesh_shape[:-1]))
    batch = tuple(names[:-1]) if len(names) == 3 else "data"
    cfg = types.SimpleNamespace(compute_dtype="float32")
    nbytes = DR._nbytes
    DR._nbytes = lambda t: t.numel()
    try:
        with DR.fake_world(int(np.prod(mesh_shape))):
            mesh = DR._device_mesh(shape, "cpu")
            with FakeTensorMode(allow_non_fake_inputs=True):
                table = DR._put(torch.empty(V, D), sh.P("model", "data"),
                                mesh).requires_grad_(True)
                tokens = DR._put(torch.empty(B, S, dtype=torch.int32),
                                 sh.P(batch, None), mesh)
                c = DR._put(torch.empty(B, S, D), sh.P(batch, None, None),
                            mesh)
                acc = DR.Accounting("cpu", mesh)
                with acc, sh.activation_mesh(mesh):
                    x = _embed_in({"embed": table}, {"tokens": tokens}, cfg)
                    torch.autograd.grad((x * c).sum(), [table])
    finally:
        DR._nbytes = nbytes
    return [(op, shapes, n) for op, shapes, flops, n, _ in acc.rows
            if not flops]


@pytest.mark.parametrize("point", ROW_GATHER_POINTS,
                         ids=lambda p: "x".join(map(str, p[-1])))
def test_row_gather_trace_is_the_references(point, reference_rows):
    """At each ROW_GATHER_POINT the reference reads ``rows`` and the port's
    trace of the lookup runs its collectives: the row blocks gathered over
    'model', the tokens permuted over ('data', 'model'), the result
    gathered over 'model' (('pod', 'model') on 2 x 16 x 16, then its D
    over 'data'), the result's gradient moved by the caller's constraint,
    the table's gradient all-reduced over the result's group."""
    ref = reference_rows[ROW_GATHER_POINTS.index(point)]
    assert ref["layout"] == "rows"
    rows = trace_lookup(*point)
    mine = _port_kinds([(op, shapes) for op, shapes, _ in rows], point[-1])
    theirs = _reference_kinds(ref["collectives"])
    assert [k[:2] for k in mine] == [k[:2] for k in theirs], (mine, theirs)
    for (op, _, n), (_, _, want) in zip(rows, theirs):
        assert abs(n / want - 1) < ELEMENTS_REL, (op, n, want)
    gathers = [k for k in mine if k[0] == "all-gather"]
    assert gathers[0] == ("all-gather", "model",
                          point[0] * point[1] // point[-1][-2])


def test_smoke_lookup_cases_are_the_references(reference_rows):
    """chip_smoke.py's TABLE_MOVE_CASES: the reference reads each case's
    layout, and at the row-gather case ``row_gather_collectives`` is the
    reference's list (kind, mesh axes, elements; the permute of the tokens
    an all-to-all on the rig)."""
    smoke = load_chip_smoke()
    refs = reference_rows[len(ROW_GATHER_POINTS):]
    assert [r["layout"] for r in refs] == [
        layout for layout, _ in smoke.TABLE_MOVE_CASES]
    for (layout, S), ref, point in zip(smoke.TABLE_MOVE_CASES, refs,
                                       _smoke_points(smoke)):
        if layout != "rows":
            continue
        V, D, _, _, mesh = point
        want = [("all-to-all" if k == "collective-permute" else k, a, n)
                for k, a, n in _reference_kinds(ref["collectives"])]
        assert smoke.row_gather_collectives(
            V, D, smoke.TABLE_MOVE_BATCH, S, tuple(mesh)) == want


@pytest.mark.parametrize("name", ["make_local_mesh", "run_ranks"])
def test_rank_launchers_default_to_the_card(name):
    """Both launchers default to ``device="cuda"``; without a card they
    raise (``resolve_device``'s error) before any process group or rank
    is made."""
    from repro_torch.launch import mesh as mesh_mod

    fn = getattr(mesh_mod, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if name == "run_ranks":
            fn(abs, 2)
        else:
            fn(1, 1)
