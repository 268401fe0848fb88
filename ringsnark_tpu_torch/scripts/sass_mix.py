"""The instruction mix of the draw, lift, encryption and MAC kernels as
compiled: ``cuobjdump -sass`` of the library that ``cuda_ntt.build()``
makes, each kernel's innermost loops with their instructions by the pipe
they issue on.

    python3 -m ringsnark_tpu_torch.scripts.sass_mix [--out FILE]

Prints one JSON object: for each kernel instance (``encrypt_kernel<1>``,
``lift_kernel<1,0>``, ...) its instructions in all and, for each innermost
loop (a backward branch with no other inside it), the instructions of one
pass by class: ``alu`` (the integer ALU: shifts, logic, adds, compares,
selects, min/max, LEA), ``fma`` (IMAD*, IMUL: the FMA pipe's integer
multiplier), ``xu`` (POPC, FLO, BREV), ``mem`` (loads and stores),
``uniform`` (the uniform datapath, U*), ``control`` (branches and the
like) and ``other``; beside them the funnel-shift rotations (``SHF.L.W``:
20 a threefry2x32 word) and the global stores of a pass.  Conditional code
inside a loop is counted whether it runs or not.  The MAC kernels'
(``mac_kernel<P,bcast>``, ``mac_drawn_kernel<P,bcast>``) loops that load
rows are labelled ``rows``, with the rows a pass takes (its 16-byte loads
over the ones a row needs: c0, c1 unless drawn, and each operand unless
it is a broadcast) and the instructions per column and row (a thread
takes four columns); any other loop of theirs is ``other``.  Needs ``nvcc`` and
``cuobjdump`` (PATH or $CUDA_HOME/bin); the card is not used.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
from collections import Counter

from ..ops import cuda_ntt

KERNELS = ("draw_kernel", "cbd_kernel", "lift_kernel", "encrypt_kernel", "mac_kernel",
           "mac_drawn_kernel")
_INSN = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"\bBRA\s+(?:`\()?0x([0-9a-f]+)")


def _cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                              "cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found (PATH, $CUDA_HOME/bin)")


def pipe(opcode: str) -> str:
    """The class of one SASS opcode (its base, before the first dot)."""
    base = opcode.split(".")[0]
    if base in ("IMAD", "IMUL"):
        return "fma"
    if base in ("POPC", "FLO", "BREV"):
        return "xu"
    if base in ("LDG", "STG", "LDC", "LDS", "STS", "LDL", "STL", "LD", "ST", "ATOM", "ATOMG",
                "RED", "REDG"):
        return "mem"
    if base.startswith("U") or base in ("S2UR", "R2UR"):
        return "uniform"
    if base in ("BRA", "EXIT", "CALL", "RET", "BSSY", "BSYNC", "WARPSYNC", "BAR", "NOP",
                "DEPBAR", "MEMBAR", "YIELD", "BREAK", "JMP"):
        return "control"
    if base in ("CS2R", "S2R", "MOV", "SHFL", "VOTE", "MATCH", "P2R", "R2P"):
        return "other"
    return "alu"


def _opcode(text: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]


def _name(mangled: str) -> str | None:
    """``encrypt_kernel<1>`` from the mangled name (template bools and ints
    as digits), or None for a kernel this script does not read."""
    for k in sorted(KERNELS, key=len, reverse=True):
        m = re.search(rf"\d{k}(I((?:L[bi]\d+E)+)E)?", mangled)
        if m:
            args = re.findall(r"L[bi](\d+)E", m.group(2) or "")
            return f"{k}<{','.join(args)}>" if args else k
    return None


def functions(sass: str) -> dict:
    """{kernel: [(address, text), ...]} of the kernels of KERNELS."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        head, _, body = part.partition("\n")
        name = _name(head.strip())
        if name:
            out[name] = [(int(m.group(1), 16), m.group(2))
                         for m in map(_INSN.match, body.split("\n")) if m]
    return out


def mix(insns) -> dict:
    """Instructions by class, rotations and global stores."""
    ops = [_opcode(t) for _, t in insns]
    counts = Counter(pipe(o) for o in ops)
    return {"instructions": len(ops), **{k: counts.get(k, 0) for k in (
        "alu", "fma", "xu", "mem", "uniform", "control", "other")},
        "rotations": sum(o.startswith("SHF.L.W") for o in ops),
        "stores": sum(o.startswith("STG") for o in ops)}


def row_loop(name: str, loop: dict, insns) -> dict:
    """The label of a MAC kernel's loop and, for a loop over rows, the rows
    of a pass and the classes per column and row."""
    m = re.fullmatch(r"(mac_kernel|mac_drawn_kernel)<(\d+),(\d+)>", name)
    if not m:
        return {}
    P, bcast = int(m.group(2)), int(m.group(3))
    per_row = (1 if m.group(1) == "mac_drawn_kernel" else 2) + (0 if bcast else P)
    wide = sum(_opcode(t).startswith("LDG") and ".128" in _opcode(t) for _, t in insns)
    if not wide or wide % per_row:
        return {"label": "other"}
    rows = wide // per_row
    return {"label": "rows", "rows": rows,
            "per_column_row": {k: loop[k] / (4 * rows) for k in (
                "instructions", "alu", "fma", "xu", "mem", "uniform", "control", "other")}}


def innermost_loops(insns) -> list:
    """(first, last) addresses of every loop with no loop inside it."""
    loops = []
    for addr, text in insns:
        m = _BRANCH.search(text)
        if m and int(m.group(1), 16) < addr:  # not the trap that branches to itself
            loops.append((int(m.group(1), 16), addr))
    return sorted((a, b) for a, b in loops
                  if not any((c, d) != (a, b) and a <= c and d <= b for c, d in loops))


def report(lib_path) -> dict:
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for name, insns in sorted(functions(sass).items()):
        loops = []
        for a, b in innermost_loops(insns):
            body = [(x, t) for x, t in insns if a <= x <= b]
            loop = {"first": hex(a), "last": hex(b), **mix(body)}
            loops.append({**loop, **row_loop(name, loop, body)})
        out[name] = {**mix(insns), "loops": loops}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)
    result = {"library": str(cuda_ntt.build().path), "kernels": report(cuda_ntt.build().path)}
    text = json.dumps(result, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
