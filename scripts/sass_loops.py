"""The instructions that a kernel's loops issue, from its SASS.

Runs ``cuobjdump -sass`` on a built library of the port (``traverse`` or
``probes``; built first if needed), or reads a listing it wrote
(``--sass FILE``), finds each kernel whose mangled name holds one of the
given names, and splits its code at the backward branches: every ``BRA``
to an address (or label) above it closes a loop. For each loop
it prints the instructions between label and branch, by opcode and by
class (f32 add, mul, fma, min/max, compare, select; packed bf16 and f16;
integer; shared and global memory; special functions; control), the
classes that bound a kernel's operations on the card. An unrolled loop
shows its unroll factor in the count of its loads.

Usage: python scripts/sass_loops.py traverse|probes NAME...
       [--sass FILE] [--json PATH]

It is a measurement script, not part of the port: the counts it printed
stand in PERF.md and in the bounds' constants (chip_smoke.py,
glaze_tpu_torch/tools/bench_bf16_slab.py).
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")
_TARGET = re.compile(r"\(\s*(\.L_x_\d+)\s*\)|\b(0x[0-9a-f]+)\b")

# opcode (before the first '.') -> class; packed 16-bit opcodes are split
# by their .BF16_V2 modifier below
CLASSES = {
    "FADD": "f32_add", "FMUL": "f32_mul", "FFMA": "f32_fma",
    "FMNMX": "f32_minmax", "FSETP": "f32_compare", "FSET": "f32_compare",
    "FSEL": "select", "SEL": "select", "FCHK": "f32_compare",
    "HADD2": "x2_add", "HMUL2": "x2_mul", "HFMA2": "x2_fma",
    "HMNMX2": "x2_minmax", "HSETP2": "x2_compare", "HSET2": "x2_compare",
    "VHMNMX": "x2_minmax",  # three-input packed min/max: two operations
    "MUFU": "special",
    "IADD3": "int", "IMAD": "int", "LEA": "int", "LOP3": "int",
    "SHF": "int", "ISETP": "int", "IABS": "int", "IMNMX": "int",
    "PRMT": "int", "SGXT": "int", "BMSK": "int", "FLO": "int", "POPC": "int",
    "IMUL": "int", "VIADD": "int", "IDP": "int", "VIMNMX": "int",
    "UIADD3": "uniform", "ULOP3": "uniform", "USHF": "uniform",
    "ULEA": "uniform", "UIMAD": "uniform", "UISETP": "uniform",
    "USEL": "uniform", "UPRMT": "uniform",
    "F2F": "convert", "F2FP": "convert", "I2F": "convert", "F2I": "convert",
    "I2FP": "convert", "F2IP": "convert",
    "LDS": "shared", "STS": "shared", "LDSM": "shared",
    "LDG": "global", "STG": "global", "LD": "global", "ST": "global",
    "LDC": "const", "ULDC": "const",
    "MOV": "move", "UMOV": "move", "S2R": "move", "CS2R": "move",
    "S2UR": "move", "R2UR": "move", "SHFL": "shuffle",
    "VOTE": "vote", "VOTEU": "vote", "MATCH": "vote",
    "BRA": "control", "BSSY": "control", "BSYNC": "control",
    "WARPSYNC": "control", "EXIT": "control", "BAR": "control",
    "NOP": "control", "YIELD": "control", "BREAK": "control",
    "RET": "control", "CALL": "control", "PLOP3": "predicate",
    "P2R": "predicate", "R2P": "predicate",
    "HMMA": "tensor", "IMMA": "tensor",
}
# the classes that are float arithmetic (what the bounds count)
FLOAT = ("f32_add", "f32_mul", "f32_fma", "f32_minmax", "f32_compare",
         "x2_add", "x2_mul", "x2_fma", "x2_minmax", "x2_compare",
         "bf16x2_add", "bf16x2_mul", "bf16x2_fma", "bf16x2_minmax",
         "bf16x2_compare", "select", "special")


def cuobjdump() -> str:
    path = shutil.which("cuobjdump")
    if path is None and os.path.exists("/usr/local/cuda/bin/cuobjdump"):
        path = "/usr/local/cuda/bin/cuobjdump"
    if path is None:
        raise RuntimeError("cuobjdump not found")
    return path


def library(which: str) -> str:
    """The built library of ``traverse`` or ``probes``."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if which == "traverse":
        from glaze_tpu_torch.accel import traverse_cuda as mod
    elif which == "probes":
        from glaze_tpu_torch.tools import probes_cuda as mod
    else:
        raise SystemExit(f"unknown library {which!r}: traverse or probes")
    return mod.build()


def functions(sass: str):
    """{mangled name: [(kind, value), ...]} where kind is 'label' (name)
    or 'insn' ((opcode, operands, address))."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            cur.append(("label", m.group(1)))
            continue
        m = _INSN.search(line)
        if m:
            cur.append(("insn", (m.group(3), m.group(4).strip(),
                                 int(m.group(1), 16))))
    return out


def classify(opcode: str) -> str:
    base = opcode.split(".")[0]
    cls = CLASSES.get(base, "other")
    if cls.startswith("x2_") and "BF16" in opcode:
        cls = "bf16" + cls
    return cls


def loops(body):
    """Each backward branch as (first, last) instruction indices of the
    loop it closes, innermost first (by length). Returns the instructions
    as (opcode, operands) and the loops."""
    insns, at = [], {}
    for kind, value in body:
        if kind == "label":
            at[value] = len(insns)
        else:
            at[value[2]] = len(insns)
            insns.append(value[:2])
    found = []
    for i, (op, args) in enumerate(insns):
        if op.split(".")[0] != "BRA":
            continue
        m = _TARGET.search(args)
        if m is None:
            continue
        target = at.get(m.group(1) if m.group(1) else int(m.group(2), 16))
        if target is not None and target <= i:
            found.append((target, i))
    return insns, sorted(set(found), key=lambda r: r[1] - r[0])


def summarize(insns, first, last):
    ops = collections.Counter(op for op, _ in insns[first:last + 1])
    classes = collections.Counter()
    for op, n in ops.items():
        classes[classify(op)] += n
    return {"instructions": last - first + 1,
            "float_ops": sum(classes[c] for c in FLOAT),
            "classes": dict(sorted(classes.items())),
            "opcodes": dict(ops.most_common())}


def analyze(which: str, names, sass=None):
    """The loops of the kernels of ``which`` whose names hold one of
    ``names``, from the listing ``sass`` (default: cuobjdump's of the
    library, built if needed)."""
    if sass is None:
        sass = subprocess.run([cuobjdump(), "-sass", library(which)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
    report = {}
    for fn, body in functions(sass).items():
        if not any(n in fn for n in names):
            continue
        insns, found = loops(body)
        report[fn] = {
            "whole": summarize(insns, 0, len(insns) - 1),
            "loops": [dict(first=a, last=b, **summarize(insns, a, b))
                      for a, b in found]}
    return report


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {}
    for flag in ("--json", "--sass"):
        if flag in argv:
            k = argv.index(flag)
            opts[flag] = argv[k + 1]
            del argv[k:k + 2]
    out = opts.get("--json")
    if len(argv) < 2:
        raise SystemExit(__doc__)
    sass = None
    if "--sass" in opts:
        with open(opts["--sass"]) as f:
            sass = f.read()
    report = analyze(argv[0], argv[1:], sass)
    if not report:
        raise SystemExit(f"no kernel of {argv[0]} matches {argv[1:]}")
    for fn, r in report.items():
        w = r["whole"]
        print(f"{fn}: {w['instructions']} instructions, "
              f"{len(r['loops'])} loops")
        for k, lp in enumerate(r["loops"]):
            print(f"  loop {k} [{lp['first']}..{lp['last']}]: "
                  f"{lp['instructions']} instructions, {lp['float_ops']} "
                  f"float; {lp['classes']}")
            print(f"    opcodes {lp['opcodes']}")
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
