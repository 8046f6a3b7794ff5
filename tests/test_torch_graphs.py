"""Construction layer of the PyTorch port against the JAX reference: every
spec of the benchmarks' lists builds the same graph (edges, loops, gather
operands, closed forms, meta), the registry resolves the same families, and
the scipy BFS 2-colouring equals networkx's colouring."""
import numpy as np
import pytest

from repro_torch import specs
from repro_torch.api import registry as PR
from repro_torch.core import properties as PP
from repro_torch.core import spectral as PS
from repro_torch.interop import topology_from_arrays
from test_torch_harness import load_reference

#: every spec of table1 / lps_bench / routing_eval, once each, in order
ALL_SPECS = list(dict.fromkeys(specs.TABLE1_SPECS + specs.LPS_SPECS
                               + specs.ROUTING_EVAL_SPECS))


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _same_optional(a, b):
    if a is None or b is None:
        assert a is None and b is None
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", ALL_SPECS)
def test_construction_matches_reference(ref, spec):
    want = ref.registry.build(spec)
    got = PR.build(spec)
    assert (got.name, got.n) == (want.name, want.n)
    np.testing.assert_array_equal(got.edges, want.edges)
    assert got.edges.dtype == want.edges.dtype
    _same_optional(got.loops, want.loops)
    assert got.meta == want.meta
    tab, w = got.gather_operands()
    tab_r, w_r = want.gather_operands()
    np.testing.assert_array_equal(tab, tab_r)
    np.testing.assert_array_equal(w, w_r)
    assert tab.dtype == tab_r.dtype == np.int32
    try:
        nt_r = want.neighbor_table()
    except ValueError:
        with pytest.raises(ValueError, match="edge-regularity"):
            got.neighbor_table()
    else:
        np.testing.assert_array_equal(got.neighbor_table(), nt_r)
    fam, bound = PR.parse_spec(spec)
    fam_r, bound_r = ref.registry.parse_spec(spec)
    assert (fam.name, bound) == (fam_r.name, bound_r)
    forms = (fam.forms(*bound[fam.params[0][0]]) if fam.variadic
             else fam.forms(**bound))
    forms_r = (fam_r.forms(*bound_r[fam_r.params[0][0]]) if fam_r.variadic
               else fam_r.forms(**bound_r))
    assert forms == forms_r


@pytest.mark.parametrize("spec", ALL_SPECS)
def test_two_colouring_matches_networkx(ref, spec):
    """The port's BFS 2-colouring (no networkx) against the reference's
    networkx colouring: same verdict, and on bipartite graphs the same sign
    vector (each component's lowest vertex gets colour 1, as networkx
    gives it)."""
    import networkx as nx

    want = ref.registry.build(spec)
    got = PR.build(spec)
    bip = nx.is_bipartite(want.to_networkx())
    assert PS._is_bipartite(got) == bip
    if bip:
        np.testing.assert_array_equal(PS._bipartite_sign(got),
                                      ref.spectral._bipartite_sign(want))
        assert len(PS.trivial_deflation(got)) == 2
    else:
        with pytest.raises(ValueError, match="not bipartite"):
            PS._bipartite_sign(got)


def test_two_colouring_per_component_and_isolates(ref):
    """Disconnected and isolated vertices: colours per component as networkx
    does (isolates get colour 0, i.e. sign +1)."""
    edges = np.array([[0, 1], [1, 2], [4, 5], [5, 6], [6, 7], [7, 4]])
    got = topology_from_arrays("two_paths", 9, edges)
    want = ref.graphs.Topology("two_paths", 9, edges)
    assert PS._is_bipartite(got)
    np.testing.assert_array_equal(PS._bipartite_sign(got),
                                  ref.spectral._bipartite_sign(want))
    odd = topology_from_arrays("triangle", 3, [[0, 1], [1, 2], [2, 0]])
    assert not PS._is_bipartite(odd)


def test_registry_families_match_reference_except_synthesis(ref):
    """Every family of the reference is registered, the synthesis families
    included (they search on the requested device; their graphs are
    compared in test_torch_synthesis.py)."""
    assert set(PR.families()) == set(ref.registry.families())
    for name in PR.families():
        fam = PR.get(name)
        if fam.default_instance:
            assert PR.build(fam.default_instance, device="cpu").n == \
                ref.registry.build(fam.default_instance).n
    with pytest.raises(PR.SpecError, match="did you mean"):
        PR.build("hypercub(4)")


@pytest.mark.parametrize("spec", ["lps(13,5)", "random_regular(256,6,0)",
                                  "petersen_torus(5,4)", "ccc(6)",
                                  "data_vortex(8,4)"])
def test_properties_match_reference(ref, spec):
    want = ref.registry.build(spec)
    got = PR.build(spec)
    vt = bool(got.meta.get("vertex_transitive"))
    assert PP.diameter(got, vertex_transitive=vt) == \
        ref.properties.diameter(want, vertex_transitive=vt)
    mask = np.arange(got.n) < got.n // 2
    assert PP.bisection_witness(got, mask) == \
        ref.properties.bisection_witness(want, mask)


def test_topology_from_arrays_copies_and_relabels(ref):
    want = ref.registry.build("lps(13,17)")
    perm = np.random.default_rng(3).permutation(want.n)
    got = topology_from_arrays("lps(13,17)/relabel", want.n, perm[want.edges],
                               None, {"bipartite": False})
    assert got.radix == want.radix and got.m == want.m
    assert got.edges is not want.edges
    d_got = np.sort(PS.laplacian_spectrum(got))
    d_want = np.sort(ref.spectral.laplacian_spectrum(want))
    np.testing.assert_allclose(d_got, d_want, atol=1e-9)
