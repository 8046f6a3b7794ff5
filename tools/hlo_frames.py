"""The functions on the Python stack where each instruction of an XLA HLO
text dump was traced, read from its stack-frame tables (``FileNames``,
``FunctionNames``, ``FileLocations``, ``StackFrames``).  Text parsing
only, no jax: ``tools/dryrun_attribution.py --functions`` and
``tests/test_torch_dryrun.py`` load it in the subprocess that lowers the
reference's cells (``PYTHONPATH`` holding ``tools``)."""
from __future__ import annotations

import re
from typing import Callable, List

_TABLES = ("FileNames", "FunctionNames", "FileLocations", "StackFrames")


def stack_functions(hlo: str) -> Callable[[str], List[str]]:
    """For the module ``hlo``, a function of one instruction's line: the
    names of the functions on the stack that traced it, innermost first
    ([] where the line names no stack frame)."""
    tab, sec = {k: {} for k in _TABLES}, None
    for line in hlo.splitlines():
        if line in tab:
            sec = line
            continue
        m = re.match(r"(\d+) (.*)", line) if sec else None
        if not m:
            sec = None if line.startswith(("%", "ENTRY", "HloModule")) \
                else sec
            continue
        val = m.group(2)
        tab[sec][int(m.group(1))] = (
            val.strip('"') if sec in ("FileNames", "FunctionNames")
            else {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", val)})
    locs, frames = tab["FileLocations"], tab["StackFrames"]

    def functions(line: str) -> List[str]:
        f = re.search(r"stack_frame_id=(\d+)", line)
        fid, out = int(f.group(1)) if f else None, []
        while fid in frames and len(out) < 64:
            out.append(tab["FunctionNames"][locs[
                frames[fid]["file_location_id"]]["function_name_id"]])
            parent = frames[fid]["parent_frame_id"]
            fid = None if parent == fid else parent
        return out
    return functions
