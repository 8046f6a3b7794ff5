"""Count the SASS instructions of kernel K4's step loop, per exponential.

K4 (``src/repro_torch/kernels/csrc/mamba_scan.cu``) issues one ``MUFU.EX2``
per (b, t, d, n) element, so the instructions of its hottest loop divided by
the ``MUFU.EX2`` in it are the instructions it issues per element there.  The
step loop is found as the loop with the most ``MUFU.EX2`` among the innermost
ones (backward branches with no other loop inside).  The count is static: it
says what the loop issues, not what stalls it.

Needs ``nvcc``'s ``cuobjdump`` (no card)::

    PYTHONPATH=src python tools/k4_sass.py            # build K4, dump, count
    python tools/k4_sass.py --dump sass.txt           # a saved cuobjdump -sass

Prints one JSON object per instantiation of ``scan_kernel``: its name, the
loop's address range, its instruction count (NOPs left out), its
``MUFU.EX2`` count, their ratio and the loop's opcode histogram.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from typing import Dict, List, Tuple

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\s+(?:\w+\s+)?0x([0-9a-f]+)")


def functions(dump: str) -> Dict[str, List[Tuple[int, str]]]:
    """``cuobjdump -sass`` text -> {mangled name: [(address, instruction)]}."""
    out: Dict[str, List[Tuple[int, str]]] = {}
    cur = None
    for line in dump.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(instr: str) -> str:
    """``@!P0 FFMA.FTZ R1, ...`` -> ``FFMA.FTZ``."""
    words = instr.split()
    return words[1] if words[0].startswith("@") else words[0]


def step_loop(code: List[Tuple[int, str]]) -> dict:
    """Of the innermost loops (backward branches with no other loop inside
    them), the one with the most ``MUFU.EX2``."""
    loops = []
    for addr, ins in code:
        m = _BRA.search(ins)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(lo, hi) for lo, hi in loops
             if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                        for a, b in loops)]
    best = None
    for lo, hi in inner:
        body = [o for o in (opcode(i) for a, i in code if lo <= a <= hi)
                if o != "NOP"]
        ex2 = body.count("MUFU.EX2")
        if ex2 and (best is None or ex2 > best[2]):
            best = (lo, hi, ex2, body)
    if best is None:
        raise ValueError("no innermost loop with MUFU.EX2")
    lo, hi, ex2, body = best
    return dict(loop=[hex(lo), hex(hi)], instructions=len(body),
                ex2=ex2, per_element=len(body) / ex2,
                opcodes=dict(collections.Counter(body).most_common()))


def _cuobjdump() -> str:
    return shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dump", help="a saved `cuobjdump -sass` of K4's "
                    "library; without it K4 is built and dumped")
    ap.add_argument("--match", default="scan_kernel",
                    help="count only functions whose name holds this")
    args = ap.parse_args(argv)
    if args.dump:
        with open(args.dump) as f:
            dump = f.read()
    else:
        from repro_torch.kernels import build

        lib = build.build_all(["mamba_scan"])[0]
        dump = subprocess.run([_cuobjdump(), "-sass", str(lib)], check=True,
                              capture_output=True, text=True).stdout
    found = 0
    for name, code in functions(dump).items():
        if args.match in name:
            found += 1
            print(json.dumps(dict(function=name, **step_loop(code))))
    return 0 if found else 1


if __name__ == "__main__":
    sys.exit(main())
