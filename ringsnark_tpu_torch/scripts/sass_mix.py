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
takes four columns); any other loop of theirs is ``other``.  The lift
kernels (``lift_kernel<error,scalar>``) have a unit of their own, loop or
not: ``draw``, the straight run (no branch in or out) with the most
rotations outside every loop, per coefficient's error (40 rotations a
coefficient, one word a side); ``columns``, every innermost loop or
straight run outside loops that stores and has no rotations, per column of
a coefficient (its stores), and ``column``, the one of those loops with the
most stores (where a line holds a CTA's block, a thread's coefficients
share each column's pass); and each innermost loop that hashes, per
coefficient-word (``draw_words``: the general draw of two or more words a
side).  The NTT kernels (``ntt_kernel<inverse,log_m>``) have ``ntt``:
every loop (innermost or not) with its instructions and, beside the
classes, its shared loads and stores, global loads and stores (as
instructions and as 32-bit words: a 128-bit access moves four), barriers
(``BAR``) and shuffles (``SHFL``), per residue of a pass: the residues a
pass moves are its global stores' words where it stores, else its shared
stores' words (a twiddle is a global load, never a store).  Needs ``nvcc``
and ``cuobjdump`` (PATH or $CUDA_HOME/bin); the card is not used.
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
           "mac_drawn_kernel", "ntt_kernel")
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


def _words(opcode: str) -> int:
    """32-bit words one lane moves with a load or store opcode."""
    return 4 if ".128" in opcode else 2 if ".64" in opcode else 1


MEMORY = ("LDS", "STS", "LDG", "STG")


def memory_mix(insns) -> dict:
    """Shared and global loads and stores (instructions and words), barriers
    and shuffles."""
    ops = [_opcode(t) for _, t in insns]
    out = {}
    for m in MEMORY:
        mine = [o for o in ops if o.split(".")[0] == m]
        out[m.lower()], out[m.lower() + "_words"] = len(mine), sum(map(_words, mine))
    out["bar"] = sum(o.split(".")[0] == "BAR" for o in ops)
    out["shfl"] = sum(o.split(".")[0] == "SHFL" for o in ops)
    return out


def ntt_parts(name: str, insns) -> dict:
    """The NTT kernel's loops (module docstring); {} for any other kernel."""
    if not name.startswith("ntt_kernel<"):
        return {}
    loops = sorted({(int(m.group(1), 16), a) for a, t in insns
                    for m in [_BRANCH.search(t)] if m and int(m.group(1), 16) < a})
    out = []
    for a, b in loops:
        body = [(x, t) for x, t in insns if a <= x <= b]
        m, mem = mix(body), memory_mix(body)
        residues = mem["stg_words"] or mem["sts_words"]
        keys = CLASSES + tuple(mem)
        both = {**m, **mem}
        out.append({"first": hex(a), "last": hex(b), **both, "residues": residues,
                    "per_residue": {k: both[k] / residues for k in keys} if residues else None})
    return {"loops": out, "kernel": memory_mix(insns)}


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
    return {"label": "rows", "rows": rows, "per_column_row": per(loop, 4 * rows)}


CLASSES = ("instructions", "alu", "fma", "xu", "mem", "uniform", "control", "other")


def per(counts: dict, n: float) -> dict:
    return {k: counts[k] / n for k in CLASSES}


def segments(insns) -> list:
    """The straight runs of a kernel: cut after every branch or exit and
    before every branch target."""
    targets = {int(m.group(1), 16) for _, t in insns for m in [_BRANCH.search(t)] if m}
    runs, cur = [], []
    for addr, text in insns:
        if addr in targets and cur:
            runs.append(cur)
            cur = []
        cur.append((addr, text))
        if _opcode(text) in ("BRA", "EXIT", "RET", "JMP", "BREAK") or _BRANCH.search(text):
            runs.append(cur)
            cur = []
    return runs + ([cur] if cur else [])


def lift_parts(name: str, insns, loops) -> dict:
    """The lift kernel's units (module docstring): `draw`, `columns` and
    the labels of its loops; {} for any other kernel."""
    if not name.startswith("lift_kernel<"):
        return {}
    inside = lambda run: any(a <= run[0][0] <= b for a, b in loops)  # noqa: E731
    straight = [(run, mix(run)) for run in segments(insns) if not inside(run)]
    out = {"columns": [], "loops": []}
    draws = [(run, m) for run, m in straight if m["rotations"]]
    if draws:
        run, m = max(draws, key=lambda d: d[1]["rotations"])
        out["draw"] = {"first": hex(run[0][0]), "last": hex(run[-1][0]),
                       "coefficients": m["rotations"] / 40,
                       "per_coefficient": per(m, m["rotations"] / 40)}
    for a, b in loops:
        m = mix([(x, t) for x, t in insns if a <= x <= b])
        if m["rotations"]:
            out["loops"].append({"first": hex(a), "label": "draw_words",
                                 "per_coefficient_word": per(m, m["rotations"] / 40)})
        elif m["stores"]:
            out["columns"].append({"first": hex(a), "loop": True, "stores": m["stores"],
                                   "per_column": per(m, m["stores"])})
    for run, m in straight:
        if m["stores"] and not m["rotations"]:
            out["columns"].append({"first": hex(run[0][0]), "loop": False,
                                   "stores": m["stores"], "per_column": per(m, m["stores"])})
    loops_out = [c for c in out["columns"] if c["loop"]]
    if loops_out:  # the main path's: a thread's kPer coefficients a column, the most stores
        out["column"] = max(loops_out, key=lambda c: c["stores"])
    return out


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
        inner = innermost_loops(insns)
        for a, b in inner:
            body = [(x, t) for x, t in insns if a <= x <= b]
            loop = {"first": hex(a), "last": hex(b), **mix(body)}
            loops.append({**loop, **row_loop(name, loop, body)})
        lift = lift_parts(name, insns, inner)
        ntt = ntt_parts(name, insns)
        out[name] = {**mix(insns), "loops": loops, **({"lift": lift} if lift else {}),
                     **({"ntt": ntt} if ntt else {})}
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
