"""Constructions of every supercomputing topology surveyed in the paper (§4)
— the PyTorch port's copy of the reference constructors (numpy only).

Each constructor returns a :class:`repro_torch.core.graphs.Topology`.  The
constructions follow the paper's definitions exactly (Definitions 3-13); where
an implementation has degree irregularities the paper regularizes with
self-loops, and we do the same (Data Vortex inner/outer rings).

Every family is registered with :mod:`repro_torch.api.registry` via the
``@register`` decorators below, carrying its parameter schema and analytic
Table-1 closed forms, so consumers build instances from spec strings
(``repro_torch.api.build("slimfly(q=13)")``) instead of dispatching by hand.
"""
from __future__ import annotations

import collections
import itertools
import math
import random
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..api.registry import register
from .bounds import TABLE1 as _T1
from .graphs import Topology

__all__ = [
    "path", "path_looped", "cycle", "complete", "hypercube", "generalized_grid",
    "torus", "butterfly", "data_vortex", "cube_connected", "cube_connected_cycles",
    "clex", "g_connected_h", "dragonfly", "slimfly", "petersen_torus",
    "fat_tree", "random_regular", "petersen",
]


# --------------------------------------------------------------------------
# closed-form adapters for the registry.  Table-1 families reuse bounds.TABLE1
# (the analytic content stays in bounds.py); the elemental graphs have exact
# spectra, flagged with rho2_exact=True so tests assert equality, not <=.
# --------------------------------------------------------------------------

def _cf_exact(table_entry: Callable[..., dict]) -> Callable[..., dict]:
    """Table-1 entry whose rho2_ub is attained exactly by the construction."""
    def forms(**params) -> dict:
        return dict(table_entry(**params), rho2_exact=True)
    return forms


def _cf_path(n: int) -> dict:
    return dict(nodes=n, rho2_ub=2.0 * (1 - math.cos(math.pi / n)),
                rho2_exact=True, diameter=n - 1)


def _cf_path_looped(n: int) -> dict:
    return dict(nodes=n, radix=2, rho2_ub=2.0 * (1 - math.cos(math.pi / n)),
                rho2_exact=True, diameter=n - 1)


def _cf_cycle(n: int) -> dict:
    return dict(nodes=n, radix=2, rho2_ub=2.0 * (1 - math.cos(2 * math.pi / n)),
                rho2_exact=True, diameter=n // 2)


def _cf_complete(n: int) -> dict:
    return dict(nodes=n, radix=n - 1, rho2_ub=float(n), rho2_exact=True,
                bw_ub=float((n // 2) * (n - n // 2)), diameter=1)


def _cf_petersen() -> dict:
    return dict(nodes=10, radix=3, rho2_ub=2.0, rho2_exact=True, diameter=2)


def _cf_grid(*ks: int) -> dict:
    return dict(nodes=int(np.prod(ks)),
                rho2_ub=2.0 * (1 - math.cos(math.pi / max(ks))),
                rho2_exact=True, diameter=int(sum(k - 1 for k in ks)))


def _cf_fat_tree(depth: int, base_mult: int = 1) -> dict:
    return dict(nodes=2 ** (depth + 1) - 1)


def _cf_random_regular(n: int, k: int, seed: int = 0) -> dict:
    return dict(nodes=n, radix=k)


def _cf_dragonfly(h: str = "complete(6)") -> dict:
    """Corollary 2 for DragonFly(H); bw_ub only when H is complete."""
    from ..api.registry import parse_spec

    fam, bound = parse_spec(h)
    if fam.name == "complete":
        hn = bound["n"]
        h_edges = hn * (hn - 1) // 2
        h_bw = (hn // 2) * (hn - hn // 2)
        return _T1["dragonfly"](h_nodes=hn, h_edges=h_edges, h_bw=h_bw)
    H = fam.build(**bound)
    return dict(nodes=(H.n + 1) * H.n, radix=2.0 * H.m / H.n + 1,
                rho2_ub=1.0 + H.n / (2.0 * H.m))


# --------------------------------------------------------------------------
# elemental graphs (§2): path, looped path, cycle — the factors of grid-likes
# --------------------------------------------------------------------------

@register("path", params=dict(n=int), closed_forms=_cf_path,
          default_instance="path(7)")
def path(n: int) -> Topology:
    """P_n: the path on n vertices (length n-1).  Adjacency spectrum 2cos(pi j/(n+1))."""
    e = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    return Topology(f"path({n})", n, e)


@register("path_looped", params=dict(n=int), closed_forms=_cf_path_looped,
          default_instance="path_looped(6)")
def path_looped(n: int) -> Topology:
    """P'_n: path with self-loops at both endpoints.  Spectrum 2cos(pi j/n)."""
    e = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    loops = np.zeros(n)
    loops[0] = loops[-1] = 1.0
    return Topology(f"path_looped({n})", n, e, loops=loops)


@register("cycle", params=dict(n=int), closed_forms=_cf_cycle,
          tags=("vertex_transitive",), default_instance="cycle(8)")
def cycle(n: int) -> Topology:
    """C_n.  Adjacency spectrum 2cos(2 pi j / n)."""
    if n < 3:
        raise ValueError("cycle needs n >= 3")
    e = np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=1)
    return Topology(f"cycle({n})", n, e)


@register("complete", params=dict(n=int), closed_forms=_cf_complete,
          tags=("vertex_transitive",), default_instance="complete(8)")
def complete(n: int) -> Topology:
    """K_n: the complete graph (rho2 = n exactly)."""
    e = np.array(list(itertools.combinations(range(n), 2)), dtype=np.int64)
    return Topology(f"complete({n})", n, e)


@register("petersen", closed_forms=_cf_petersen, tags=("vertex_transitive",),
          default_instance="petersen")
def petersen() -> Topology:
    """The Petersen graph, labeled: outer 5-cycle 0-4, inner pentagram 5-9, spokes i~i+5."""
    outer = [(i, (i + 1) % 5) for i in range(5)]
    inner = [(5 + i, 5 + (i + 2) % 5) for i in range(5)]
    spokes = [(i, i + 5) for i in range(5)]
    return Topology("petersen", 10, np.array(outer + inner + spokes))


# --------------------------------------------------------------------------
# products (§4.1)
# --------------------------------------------------------------------------

def _cartesian_product(a: Topology, b: Topology, name: str) -> Topology:
    """G □ H — adjacency A_G ⊗ I + I ⊗ A_H (vertex (u, v) ↦ u * |H| + v)."""
    nb = b.n
    # edges from G: (u,u') x each v  |  edges from H: each u x (v,v')
    eg = (a.edges[:, None, :] * nb + np.arange(nb)[None, :, None]).reshape(-1, 2)
    eh = (b.edges[None, :, :] + (np.arange(a.n) * nb)[:, None, None]).reshape(-1, 2)
    loops = None
    if a.loops is not None or b.loops is not None:
        la = a.loops if a.loops is not None else np.zeros(a.n)
        lb = b.loops if b.loops is not None else np.zeros(b.n)
        loops = (la[:, None] + lb[None, :]).reshape(-1)
    return Topology(name, a.n * nb, np.concatenate([eg, eh], axis=0), loops=loops)


def generalized_grid(ks: Sequence[int]) -> Topology:
    """G_{k_1..k_d} = P_{k_1} □ ... □ P_{k_d} (Definition 4)."""
    ks = list(ks)
    if not ks:
        raise ValueError("grid needs at least one extent")
    g = path(ks[0])
    for k in ks[1:]:
        g = _cartesian_product(g, path(k), "tmp")
    g.name = f"grid({'x'.join(map(str, ks))})"
    return g


@register("grid", params=dict(ks=int), variadic=True, closed_forms=_cf_grid,
          aliases=("generalized_grid",), default_instance="grid(3,4,2)")
def _grid_from_spec(*ks: int) -> Topology:
    """Registry entry point for :func:`generalized_grid` — ``grid(3,4,2)``."""
    return generalized_grid(ks)


@register("hypercube", params=dict(d=int), closed_forms=_cf_exact(_T1["hypercube"]),
          tags=("vertex_transitive",), default_instance="hypercube(5)")
def hypercube(d: int) -> Topology:
    """Q_d = P_2^{□ d} (Definition 3).  rho_2 = 2, BW = 2^{d-1}."""
    g = generalized_grid([2] * d)
    g.name = f"hypercube({d})"
    g.meta = dict(d=d)
    return g


@register("torus", params=dict(k=int, d=int), closed_forms=_cf_exact(_T1["torus"]),
          tags=("vertex_transitive",), default_instance="torus(6,2)")
def torus(k: int, d: int) -> Topology:
    """C_k^{□ d} (Definition 5).  2d-regular on k^d vertices; rho2 = 2(1-cos(2 pi /k))."""
    if k < 3:
        raise ValueError("torus needs k >= 3 (non-degenerate cycles, paper §5)")
    g = cycle(k)
    for _ in range(d - 1):
        g = _cartesian_product(g, cycle(k), "tmp")
    g.name = f"torus({k},{d})"
    g.meta = dict(k=k, d=d)
    return g


# --------------------------------------------------------------------------
# grid variants (§4.2)
# --------------------------------------------------------------------------

@register("butterfly", params=dict(k=int, s=int),
          closed_forms=lambda **p: _T1["butterfly"](**p),
          default_instance="butterfly(3,3)")
def butterfly(k: int, s: int) -> Topology:
    """k-ary s-fly Butterfly, cyclic arrangement (Definition 6).

    Switches indexed by [s] x [k]^s; (i, a) ~ (i+1 mod s, a') where a' agrees
    with a off coordinate i (a'_i ranges over all k values).  2k-regular on
    s*k^s vertices.
    """
    n_digits = k ** s
    n = s * n_digits
    # vertex index = layer * k^s + digit-string (base-k, digit 0 most significant)
    digits = np.arange(n_digits)
    pow_i = np.array([k ** (s - 1 - i) for i in range(s)], dtype=np.int64)
    edges = []
    for i in range(s):
        j = (i + 1) % s
        di = (digits // pow_i[i]) % k          # current i-th digit
        base = digits - di * pow_i[i]          # digit i zeroed
        for v in range(k):
            tgt = base + v * pow_i[i]
            edges.append(np.stack([i * n_digits + digits, j * n_digits + tgt], axis=1))
    e = np.concatenate(edges, axis=0)
    t = Topology(f"butterfly({k},{s})", n, e, meta=dict(k=k, s=s))
    return t


@register("data_vortex", params=dict(A=int, C=int),
          closed_forms=lambda **p: _T1["data_vortex"](**p),
          default_instance="data_vortex(5,4)")
def data_vortex(A: int, C: int) -> Topology:
    """Data Vortex (Definition 7) with the paper's self-loop regularization.

    Vertices: Z_A x Z_C x Z_2^{C-1}.  Rings are a *path* in the cylinder
    coordinate (c -> c+1 transitions, no wrap), heights flip bit c within ring
    c >= 1, ring 0 has angular-only edges.  Outer/inner rings get self-loops to
    reach degree 4 (Proposition 2's convention).
    """
    H = 1 << (C - 1)
    n = A * C * H

    def vid(a, c, h):
        return (a % A) * C * H + c * H + h

    a = np.arange(A)
    h = np.arange(H)
    aa, hh = np.meshgrid(a, h, indexing="ij")
    aa, hh = aa.ravel(), hh.ravel()
    edges = []
    # rule 1: (a, c, h) ~ (a+1, c+1, h) for c in 0..C-2
    for c in range(C - 1):
        edges.append(np.stack([vid(aa, c, hh), vid(aa + 1, c + 1, hh)], axis=1))
    # rule 2: (a, c, h) ~ (a+1, c, h ^ bit(c-1)) for c in 1..C-1
    for c in range(1, C):
        edges.append(np.stack([vid(aa, c, hh), vid(aa + 1, c, hh ^ (1 << (c - 1)))], axis=1))
    # rule 3: (a, 0, h) ~ (a+1, 0, h)
    edges.append(np.stack([vid(aa, 0, hh), vid(aa + 1, 0, hh)], axis=1))
    e = np.concatenate(edges, axis=0)
    deg = np.bincount(e.reshape(-1), minlength=n)
    loops = (4 - deg).astype(np.float64)  # outer/inner rings are degree 3
    assert loops.min() >= 0 and loops.max() <= 1
    return Topology(f"data_vortex({A},{C})", n, e, loops=loops, meta=dict(A=A, C=C))


def cube_connected(G: Topology, name: Optional[str] = None) -> Topology:
    """CC(G, d) for |V(G)| = d (Definition 8, CCC semantics).

    Vertex set V(G) x {0,1}^d; copies of G at fixed height; vertex i of G
    flips hypercube bit i: (i, x) ~ (i, x XOR e_i).  The Riess-Strehl-Wanka
    factorization (Theorem 4) holds for this graph.
    """
    d = G.n
    H = 1 << d
    n = d * H
    x = np.arange(H)
    # G-edges within each height
    eg = (G.edges[None, :, :] * H + x[:, None, None]).reshape(-1, 2)
    # cube edges: (i, x) ~ (i, x ^ (1<<i)); count each once via bit test
    cube = []
    for i in range(d):
        sel = x[(x >> i) & 1 == 0]
        cube.append(np.stack([i * H + sel, i * H + (sel ^ (1 << i))], axis=1))
    e = np.concatenate([eg.reshape(-1, 2)] + cube, axis=0)
    # vertex (i, x) ↦ i * H + x
    return Topology(name or f"cube_connected({G.name})", n, e, meta=dict(d=d))


@register("ccc", params=dict(d=int), closed_forms=lambda **p: _T1["ccc"](**p),
          aliases=("cube_connected_cycles",), default_instance="ccc(4)")
def cube_connected_cycles(d: int) -> Topology:
    """CCC(d) = CC(C_d, d): 3-regular on d * 2^d vertices."""
    g = cube_connected(cycle(d), name=f"ccc({d})")
    g.meta = dict(d=d)
    return g


@register("clex", params=dict(k=int, ell=int),
          closed_forms=lambda **p: _T1["clex"](**p),
          default_instance="clex(3,3)")
def clex(k: int, ell: int, G: Optional[Topology] = None) -> Topology:
    """(Generalized) CLEX C(G, ell) on k^ell vertices (Definition 9 / Lemma 3).

    Undirected multigraph form: every directed edge of the digraph becomes an
    undirected edge, so cross-level pairs ((v..., i), (v..., j, v_l)) carry
    weight per Lemma 3's M operator (weight 2 when i=b, j=a both hold).
    Regular of degree t + 2k(ell-1) for t-regular G (K_k: 2*ell*k - k - 1).
    """
    if G is None:
        G = complete(k)
    if G.n != k:
        raise ValueError("G must have k vertices")
    n = k ** ell
    idx = np.arange(n)
    edges = [
        # G acts on the most significant digit: A_G ⊗ I_{k^{ell-1}}
        (G.edges[:, None, :] * (k ** (ell - 1)) + np.arange(k ** (ell - 1))[None, :, None]).reshape(-1, 2)
    ]
    loops = np.zeros(n)
    # cross-level operator M on digit pair (j, j+1): I_{k^j} ⊗ M ⊗ I_{k^{ell-2-j}}
    # M_{(i,j),(a,b)} = [i=b] + [j=a]  (so (i,j)<->(j,i) has weight 2).
    # Edge set: for all digit pairs (p, q) at positions (j, j+1) and all values c:
    # connect (.., p, q, ..) to (.., c, p, ..) — i.e. new pair (a,b)=(c,p): checks
    # i=b (p=p ✓) always; weight 2 iff additionally j=a i.e. q=c.
    for j in range(ell - 1):
        hi = k ** j                   # digits above the pair
        mid = k ** (ell - 2 - j)      # digits below the pair
        pair_stride = mid             # value of digit (j+1) position
        top_stride = mid * k          # value of digit j position
        rest = idx
        dj = (rest // top_stride) % k       # digit j   ("i" of M-row)
        dj1 = (rest // pair_stride) % k     # digit j+1 ("j" of M-row)
        base = rest - dj * top_stride - dj1 * pair_stride
        for c in range(k):
            tgt = base + c * top_stride + dj * pair_stride   # (a,b) = (c, d_j)
            # Each *type-1 ordered pair* (u -> v with v's digit j+1 == u's digit
            # j) is generated exactly once over the (u, c) loop.  The unordered
            # M-weight is [type-1(u,v)] + [type-1(v,u)], so the multiset of
            # generated pairs, read as undirected edges, realizes M exactly:
            # "swap" pairs (weight 2) appear from both directions, weight-1
            # pairs once.  Diagonal (u1 == u2, c == u1): M[(p,p),(p,p)] = 2.
            u = rest
            same = tgt == u
            if same.any():
                loops[u[same]] += 2.0
            uu, tt = u[~same], tgt[~same]
            edges.append(np.stack([uu, tt], axis=1))
    e = np.concatenate(edges, axis=0)
    e = np.sort(e, axis=1)  # canonical undirected orientation (multiset kept)
    return Topology(f"clex({k},{ell})" if G.name == f"complete({k})" else f"clex({G.name},{ell})",
                    n, e, loops=loops if loops.any() else None,
                    meta=dict(k=k, ell=ell))


# --------------------------------------------------------------------------
# miscellaneous (§4.3)
# --------------------------------------------------------------------------

def g_connected_h(G: Topology, H: Topology, k: int = 1,
                  name: Optional[str] = None) -> Topology:
    """k-fold G-connected-H (Definition 10).

    Requires G d-regular and |V(H)| = t*d.  Ports of each H-copy are split
    into d groups of t by residue mod d; the group for incident edge e of
    vertex g is indexed by e's rank among g's incident edges.  Matching edges
    pair port-groups elementwise with multiplicity k.
    """
    d = G.radix
    if H.n % d != 0:
        raise ValueError(f"|V(H)|={H.n} must be a multiple of deg(G)={d}")
    t = H.n // d
    n = G.n * H.n
    edges = []
    # copies of H
    eh = (H.edges[None, :, :] + (np.arange(G.n) * H.n)[:, None, None]).reshape(-1, 2)
    edges.append(eh)
    # rank of each edge at each endpoint
    rank = {}
    cnt = np.zeros(G.n, dtype=np.int64)
    for ei, (u, v) in enumerate(G.edges):
        rank[(ei, int(u))] = int(cnt[u]); cnt[u] += 1
        rank[(ei, int(v))] = int(cnt[v]); cnt[v] += 1
    ports = [np.arange(H.n)[np.arange(H.n) % d == r] for r in range(d)]
    match = []
    for ei, (u, v) in enumerate(G.edges):
        pu = ports[rank[(ei, int(u))]] + int(u) * H.n
        pv = ports[rank[(ei, int(v))]] + int(v) * H.n
        pair = np.stack([pu, pv], axis=1)
        match.append(np.repeat(pair, k, axis=0))
    edges.append(np.concatenate(match, axis=0))
    e = np.concatenate(edges, axis=0)
    return Topology(name or f"gch({G.name},{H.name},k={k})", n, e,
                    meta=dict(k=k, t=t, d=d))


def dragonfly(H: Topology) -> Topology:
    """DragonFly(H) = K_{|H|+1} ~ H (Definition 12).

    |H|+1 copies of H; global links: copy a, local vertex (b-1 if b>a else b)
    connects to copy b, local vertex (a if a<b else a-1) — the canonical
    all-to-all group wiring; each vertex has exactly one global port.
    """
    g = H.n          # group size = number of global ports per group = n_groups-1...
    ng = H.n + 1     # number of groups
    n = ng * H.n
    eh = (H.edges[None, :, :] + (np.arange(ng) * H.n)[:, None, None]).reshape(-1, 2)
    glob = []
    for a in range(ng):
        for b in range(a + 1, ng):
            pa = a * H.n + (b - 1)          # port of group a towards b
            pb = b * H.n + a                # port of group b towards a
            glob.append((pa, pb))
    e = np.concatenate([eh, np.array(glob, dtype=np.int64)], axis=0)
    return Topology(f"dragonfly({H.name})", n, e, meta=dict(groups=ng))


@register("dragonfly", params=dict(h=str), defaults=dict(h="complete(6)"),
          closed_forms=_cf_dragonfly,
          default_instance="dragonfly(h='complete(6)')")
def _dragonfly_from_spec(h: str = "complete(6)") -> Topology:
    """Registry entry point for :func:`dragonfly` — the group graph H is
    itself a spec string, e.g. ``dragonfly(h='complete(6)')``."""
    from ..api.registry import build as _build

    return dragonfly(_build(h))


@register("slimfly", params=dict(q=int), closed_forms=_cf_exact(_T1["slimfly"]),
          tags=("vertex_transitive",), default_instance="slimfly(5)")
def slimfly(q: int) -> Topology:
    """SlimFly MMS graph (Definition 13) for prime q ≡ 1 (mod 4).

    (3q-1)/2-regular on 2q^2 vertices; rho_2 = q exactly (Proposition 9).
    """
    if q % 4 != 1:
        raise ValueError("q must be ≡ 1 (mod 4)")
    # check primality (prime-power fields not implemented; paper's instances are prime)
    if any(q % f == 0 for f in range(2, int(q ** 0.5) + 1)):
        raise NotImplementedError("prime powers need GF(q) arithmetic; use prime q")
    # primitive root
    def is_primitive(z):
        seen, x = set(), 1
        for _ in range(q - 1):
            x = x * z % q
            seen.add(x)
        return len(seen) == q - 1
    zeta = next(z for z in range(2, q) if is_primitive(z))
    powers = [pow(zeta, i, q) for i in range(q - 1)]
    X = sorted(set(powers[0::2]))   # even powers (incl zeta^0 = 1)
    Xp = sorted(set(powers[1::2]))  # odd powers
    # q ≡ 1 (mod 4) ⟹ -1 = zeta^{(q-1)/2} is an even power, so both generator
    # sets are symmetric and the blocks are undirected Cayley graphs.
    assert (q - 1) in X, "generator set X must be symmetric"

    def vid(s, a, b):
        return s * q * q + a * q + b

    edges = []
    # intra-block edges: (0,x,y) ~ (0,x,y') iff y-y' ∈ X (X symmetric since -1∈X)
    for s, gen in ((0, X), (1, Xp)):
        for x in range(q):
            for y in range(q):
                for g in gen:
                    y2 = (y + g) % q
                    if y < y2:
                        edges.append((vid(s, x, y), vid(s, x, y2)))
    # cross edges: (0,x,y) ~ (1,m,c) iff y = m x + c
    for x in range(q):
        for y in range(q):
            for m in range(q):
                c = (y - m * x) % q
                edges.append((vid(0, x, y), vid(1, m, c)))
    return Topology(f"slimfly({q})", 2 * q * q, np.array(edges, dtype=np.int64),
                    meta=dict(q=q))


@register("petersen_torus", params=dict(a=int, b=int),
          closed_forms=lambda **p: _T1["petersen_torus"](**p),
          default_instance="petersen_torus(5,4)")
def petersen_torus(a: int, b: int) -> Topology:
    """Petersen Torus PT(a, b) (Definition 11); 4-regular on 10ab vertices.

    Historically exported under the ``peterson_torus`` misspelling; that
    alias went through a deprecation cycle and has been removed (the paper's
    graph is Petersen's, so only the correctly-spelled name remains).
    """
    if not (a >= 2 and b >= 2 and (a % 2 == 1 or b % 2 == 1)):
        raise ValueError("need a,b >= 2 with at least one odd")
    P = petersen()
    n = a * b * 10

    def vid(x, y, p):
        return ((x % a) * b + (y % b)) * 10 + p

    xs, ys = np.meshgrid(np.arange(a), np.arange(b), indexing="ij")
    xs, ys = xs.ravel(), ys.ravel()
    edges = []
    for (p, q) in P.edges:                       # internal
        edges.append(np.stack([vid(xs, ys, p), vid(xs, ys, q)], axis=1))
    edges.append(np.stack([vid(xs, ys, 6), vid(xs, ys + 1, 9)], axis=1))       # longitudinal
    edges.append(np.stack([vid(xs, ys, 1), vid(xs + 1, ys, 4)], axis=1))       # latitudinal
    edges.append(np.stack([vid(xs, ys, 2), vid(xs + 1, ys + 1, 3)], axis=1))   # diagonal
    edges.append(np.stack([vid(xs, ys, 7), vid(xs - 1, ys + 1, 8)], axis=1))   # reverse diag
    edges.append(np.stack([vid(xs, ys, 0), vid(xs + a // 2, ys + b // 2, 5)], axis=1))  # diameter
    e = np.concatenate(edges, axis=0)
    return Topology(f"petersen_torus({a},{b})", n, e, meta=dict(a=a, b=b))


@register("fat_tree", params=dict(depth=int, base_mult=int),
          defaults=dict(base_mult=1), closed_forms=_cf_fat_tree,
          default_instance="fat_tree(3)")
def fat_tree(depth: int, base_mult: int = 1) -> Topology:
    """Binary fat tree of given depth (Fig. 3's reduction example).

    Edge multiplicity doubles toward the root: leaves attach with ``base_mult``
    parallel links, the root level has ``base_mult * 2^(depth-1)``.
    """
    n = 2 ** (depth + 1) - 1
    edges = []
    for v in range(1, n):
        parent = (v - 1) // 2
        level_from_leaf = depth - int(np.floor(np.log2(v + 1)))
        mult = base_mult * (2 ** level_from_leaf)
        for _ in range(mult):
            edges.append((parent, v))
    return Topology(f"fat_tree({depth})", n, np.array(edges, dtype=np.int64),
                    meta=dict(depth=depth))


def _random_regular_edge_set(n: int, k: int,
                             rnd: random.Random) -> Optional[set]:
    """One attempt of the Steger–Wormald stub pairing (networkx's
    ``_try_creation``): shuffle the stubs, pair them off, keep the pairs
    that are new simple edges and re-pair the stubs of the rest; None when
    no suitable pair can remain."""
    def suitable(edges, potential_edges):
        if not potential_edges:
            return True
        for s1 in potential_edges:
            for s2 in potential_edges:
                if s1 == s2:         # each s1-s2 pair once
                    break
                if s1 > s2:
                    s1, s2 = s2, s1
                if (s1, s2) not in edges:
                    return True
        return False

    edges = set()
    stubs = list(range(n)) * k
    while stubs:
        potential_edges = collections.defaultdict(lambda: 0)
        rnd.shuffle(stubs)
        stubiter = iter(stubs)
        for s1, s2 in zip(stubiter, stubiter):
            if s1 > s2:
                s1, s2 = s2, s1
            if s1 != s2 and ((s1, s2) not in edges):
                edges.add((s1, s2))
            else:
                potential_edges[s1] += 1
                potential_edges[s2] += 1
        if not suitable(edges, potential_edges):
            return None
        stubs = [node for node, potential in potential_edges.items()
                 for _ in range(potential)]
    return edges


@register("random_regular", params=dict(n=int, k=int, seed=int),
          defaults=dict(seed=0), closed_forms=_cf_random_regular,
          aliases=("jellyfish",), default_instance="random_regular(64,4,seed=1)")
def random_regular(n: int, k: int, seed: int = 0) -> Topology:
    """Jellyfish-style random k-regular graph (configuration model, simple).

    The port's own copy of networkx 3.x's ``random_regular_graph(k, n,
    seed)`` (BSD-3-Clause, Copyright (C) 2004-2024 NetworkX Developers):
    Steger–Wormald stub pairing driven by ``random.Random(seed)``, retried
    until a suitable edge set is found.  Edges come out in the order
    ``list(G.edges())`` gives for that graph — vertex by vertex, each
    vertex's higher neighbors in the order their edges were inserted from
    the edge set — so the family yields the reference's graph edge for edge
    without importing networkx.
    """
    if (n * k) % 2 != 0:
        raise ValueError("n * k must be even")
    if not 0 <= k < n:
        raise ValueError("the 0 <= k < n inequality must be satisfied")
    rnd = random.Random(seed)
    edges = _random_regular_edge_set(n, k, rnd) if k else set()
    while edges is None:
        edges = _random_regular_edge_set(n, k, rnd)
    nbrs: List[List[int]] = [[] for _ in range(n)]
    for u, v in edges:                 # Graph.add_edges_from's adjacency order
        nbrs[u].append(v)
        nbrs[v].append(u)
    e = np.array([(u, v) for u in range(n) for v in nbrs[u] if v > u],
                 dtype=np.int64).reshape(-1, 2)
    return Topology(f"random_regular({n},{k})", n, e, meta=dict(k=k, seed=seed))
