"""Kernel K2 against a design that holds x in a thread-block cluster's
distributed shared memory, as the Pallas kernel held x in VMEM.

K2 (``src/repro_torch/kernels/csrc/cayley_spmv.cu``) gathers x from the L2
cache.  ``tools/k2_cluster.cu`` is the other design: a cluster of C blocks
holds x whole in its distributed shared memory, block r the rows
``[r 2^s, (r + 1) 2^s)``, a batch interleaved so that one gathered
neighbour brings the values of up to four f32 (eight bf16) vectors in one
16-byte load.  :func:`layout` picks its layout from (B, n, element size)
alone.  For each form this builds both, checks the cluster kernel against
the plain version (``cayley_spmv_ref``, the smoke's ``CAYLEY_TOL``) and, in
f32, against K2's and K1's bits, and times each as a CUDA graph over
operand copies that together exceed L2 (the smoke's method).  Run on the
card::

    PYTHONPATH=src python tools/k2_cluster.py

Prints the card's name and power limit, then one JSON object per form:
``k2_ms`` and ``cluster_ms`` (µs are these times 1e3), the layout, the
clusters the card holds at once and the clusters launched.  Exits 1 if a
result disagrees.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import math
import pathlib
import subprocess
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "tools" / "k2_cluster.cu"

#: shared memory one Hopper block can have (227 KB), and what a block keeps
#: before its slice (the mbarrier its bulk copy completes on)
SMEM_PER_BLOCK = 232_448
BARRIER_BYTES = 16
#: cluster sizes, smallest first (16 needs the non-portable cluster size)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
#: bytes of one staged row: the group's values of one index, one load
MAX_ROW_BYTES = 16
#: the smoke's tolerances and the bytes the timed operand copies exceed
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
COLD_BYTES = 120e6

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}


class Layout(NamedTuple):
    """Clusters of ``cluster`` blocks of ``threads`` threads; block r holds
    rows ``[r 2^slice_shift, (r + 1) 2^slice_shift)`` (all n where one block
    holds x) of ``group`` interleaved vectors in ``smem_bytes``."""
    cluster: int
    slice_shift: int
    group: int
    smem_bytes: int
    threads: int


def layout(B: int, n: int, elem: int) -> Optional[Layout]:
    """The layout for x (B, n) of ``elem``-byte values, or None where not
    even 16 blocks hold it.  The group is the power of two at least B but
    at most ``MAX_ROW_BYTES / elem`` values (B beyond it runs the groups one
    after another); C the smallest of ``CLUSTER_SIZES`` whose power-of-two
    slices fit a block, fewer blocks leaving fewer gathers to another
    block; 256 threads a block, 512 where a row holds 8 bf16 values."""
    if B < 1 or n < 1 or elem not in (2, 4):
        raise ValueError(f"layout: B = {B}, n = {n}, elem = {elem}")
    group = min(1 << (B - 1).bit_length(), MAX_ROW_BYTES // elem)
    for c in CLUSTER_SIZES:
        shift = max(0, (-(-n // c) - 1).bit_length())
        smem = BARRIER_BYTES + group * elem * min(1 << shift, n)
        if smem <= SMEM_PER_BLOCK:
            return Layout(c, shift, group, smem, 512 if group == 8 else 256)
    return None


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``tools/k2_cluster.cu`` built with the port's nvcc flags into
    ``build/tools/`` (named by a hash of source and flags)."""
    from repro_torch.kernels import build

    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(build.NVCC_FLAGS).encode())
    out = ROOT / "build" / "tools" / f"libk2_cluster_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".tmp")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(tmp),
                        str(SOURCE)], check=True)
        tmp.replace(out)
    lib = ctypes.CDLL(str(out))
    ci, vp = ctypes.c_int, ctypes.c_void_p
    lib.k2_cluster_launch.argtypes = [
        ci, vp, vp, vp, vp, ctypes.c_longlong, ci, ci, ci, ci, ci, ci, vp,
        ctypes.POINTER(ci), ctypes.POINTER(ci)]
    lib.k2_cluster_launch.restype = ci
    lib.k2_cluster_error_string.argtypes = [ci]
    lib.k2_cluster_error_string.restype = ctypes.c_char_p
    return lib


def cluster_matvec(x, table, loops=None, out=None):
    """The cluster kernel on K2's operands (contiguous CUDA tensors, x (n,)
    or (B, n) f32 / bf16, table (n, k) int32, loops (n,) f32 or None):
    ``(y, info)``, info the layout with ``active_clusters`` and
    ``clusters``.  Raises where no cluster holds x or the launch fails."""
    n = int(x.shape[-1])
    B = int(x.shape[0]) if x.dim() == 2 else 1
    lay = layout(B, n, x.element_size())
    if lay is None:
        raise ValueError(f"no cluster holds x: B = {B}, n = {n}, {x.dtype}")
    y = torch.empty_like(x) if out is None else out
    active, grid = ctypes.c_int(0), ctypes.c_int(0)
    lib = _library()
    rc = lib.k2_cluster_launch(
        _DTYPE_CODE[x.dtype], x.data_ptr(), table.data_ptr(),
        None if loops is None else loops.data_ptr(), y.data_ptr(), n,
        int(table.shape[1]), B, lay.cluster, lay.slice_shift, lay.group,
        lay.threads, torch.cuda.current_stream(x.device).cuda_stream,
        ctypes.byref(active), ctypes.byref(grid))
    if rc != 0:
        raise RuntimeError(f"k2_cluster_launch failed ({lay}): "
                           + lib.k2_cluster_error_string(rc).decode())
    return y, dict(lay._asdict(), active_clusters=active.value,
                   clusters=grid.value)


def _graph_ms(fn, arg_sets, reps: int) -> float:
    """Per-call device time of ``reps`` calls cycling through ``arg_sets``,
    one CUDA graph, median of 5 replays (chip_smoke.py's ``_graph_ms``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in arg_sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[2]


#: (form, table: a registry spec or (n, k) drawn at random, B (0: (n,)),
#: dtype, loops): lps(61,5)'s forms of the smoke, one vector at C 1 with
#: every gather local, and batches over LPS, random-lift and random tables
FORMS = (
    ("lps(61,5) f32 (n,) loops", "lps(61,5)", 0, torch.float32, True),
    ("lps(61,5) f32 (1,n) loops", "lps(61,5)", 1, torch.float32, True),
    ("lps(61,5) bf16 (n,) loops", "lps(61,5)", 0, torch.bfloat16, True),
    ("lps(61,5) f32 (4,n) loops", "lps(61,5)", 4, torch.float32, True),
    ("hypercube(16) f32 (n,)", "hypercube(16)", 0, torch.float32, False),
    ("random n=100003 k=7 f32 (n,) loops", (100_003, 7), 0, torch.float32,
     True),
    ("random n=58000 k=32 f32 (n,) loops", (58_000, 32), 0, torch.float32,
     True),
    ("lps(41,37) f32 (4,n)", "lps(41,37)", 4, torch.float32, False),
    ("lps(41,37) f32 (8,n)", "lps(41,37)", 8, torch.float32, False),
    ("xpander(32768,32,0,0) f32 (4,n)", "xpander(32768,32,0,0)", 4,
     torch.float32, False),
    ("xpander(65536,32,0,0) f32 (3,n)", "xpander(65536,32,0,0)", 3,
     torch.float32, False),
    ("xpander(65536,32,0,0) f32 (4,n)", "xpander(65536,32,0,0)", 4,
     torch.float32, False),
    ("xpander(65536,32,0,0) f32 (8,n)", "xpander(65536,32,0,0)", 8,
     torch.float32, False),
    ("xpander(65536,32,0,0) bf16 (8,n)", "xpander(65536,32,0,0)", 8,
     torch.bfloat16, False),
    ("random n=58000 k=32 f32 (4,n) loops", (58_000, 32), 4, torch.float32,
     True),
)


def run_form(form, table_src, B, dtype, with_loops, rng, tables) -> dict:
    from repro_torch.api import registry as REG
    from repro_torch.kernels import cayley_spmv as CS
    from repro_torch.kernels import spmv as KS

    dev = torch.device("cuda")
    if isinstance(table_src, str):
        if table_src not in tables:
            tables[table_src] = np.asarray(REG.build(
                table_src, device=dev).gather_operands()[0])
        tab_np = tables[table_src]
    else:
        n, k = table_src
        tab_np = rng.integers(0, n, size=(n, k))
    n = tab_np.shape[0]
    table = torch.as_tensor(tab_np, dtype=torch.int32, device=dev)
    x = torch.as_tensor(rng.standard_normal((B, n) if B else n),
                        dtype=dtype, device=dev)
    loops = torch.as_tensor(rng.integers(0, 3, size=n), dtype=torch.float32,
                            device=dev) if with_loops else None
    y_c, info = cluster_matvec(x, table, loops)
    y_p = CS.cayley_spmv_ref(x, table, loops)
    y_2 = CS.cayley_spmv_cuda(x, table, loops)
    torch.cuda.synchronize()
    err = float((y_c.float() - y_p.float()).abs().max())
    tol = TOL[dtype]
    ok = bool(torch.allclose(y_c.float(), y_p.float(), atol=tol, rtol=tol))
    row = dict(form=form, n=n, k=int(table.shape[1]), max_abs_err=err,
               within_tol=ok)
    if dtype == torch.float32:
        row["equal_to_k2"] = bool(torch.equal(y_c, y_2))
        row["equal_to_k1"] = bool(torch.equal(y_c, KS.spmv_cuda(x, table,
                                                                 loops)))
        ok = ok and row["equal_to_k2"] and row["equal_to_k1"]
    nbytes = 2 * x.numel() * x.element_size() + table.numel() * 4 + \
        (n * 4 if loops is not None else 0)
    copies = max(2, min(64, math.ceil(COLD_BYTES / nbytes)))
    sets = [(x.clone(), table.clone(),
             None if loops is None else loops.clone(), torch.empty_like(x))
            for _ in range(copies)]
    reps = max(64, copies)
    row["k2_ms"] = _graph_ms(lambda a, t, w, o: CS.cayley_spmv_cuda(a, t, w),
                             sets, reps)
    row["cluster_ms"] = _graph_ms(cluster_matvec, sets, reps)
    row.update(info, cold_copies=copies, ok=ok)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    tables: dict = {}
    ok = True
    for form in FORMS:
        row = run_form(*form, rng, tables)
        print(json.dumps(row), flush=True)
        ok = ok and row["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
