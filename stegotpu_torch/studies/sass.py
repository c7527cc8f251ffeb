"""Instruction counts of the built kernels, read from their machine code.

``cuobjdump -sass`` of the kernel library lists each kernel's SASS;
``counts`` tallies, per kernel instantiation, the opcodes that decide the
stripe kernels' arithmetic on Hopper: conversions (I2F, I2FP, F2I, F2F,
FRND: the conversion pipe, 16 results a clock an SM by the CUDA C++
Programming Guide's throughput table, against 128 for FFMA/FADD and 64 for
the integer ALU), the multi-function unit (MUFU: the divide's reciprocal),
the divide's range check (FCHK), shared-memory loads (LDS: the DCT matrix
where a kernel keeps it there), global loads (LDG) and barriers (BAR),
byte permutes (PRMT) and the FMAs (FFMA;
``FFMA_imm``: those with an immediate float operand, where the compiler
folded the DCT matrix's constant into the instruction; ``FFMA_cbank``:
those that read an operand from a constant bank other than the
parameters' bank 0).

    python -m stegotpu_torch.studies.sass [--lib PATH] [--kernels a,b]

prints one JSON row per matching instantiation (default: K1-K6, the
stripe kernels, at rn=2; a kernel that is no template, such as K7's
``kron_embed_kernel``, matches as it is). ``--lib`` reads another
build of the library, e.g. a parent checkout's. It needs the CUDA
toolkit's ``cuobjdump``, not a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

# the kernel templates of K1-K6
DEFAULT_KERNELS = ("qim_embed_kernel", "qim_extract_packed_kernel",
                   "qim_embed_check_kernel", "qim_roundtrip_packed_kernel",
                   "qim_extract_rows_kernel", "qim_roundtrip_rows_kernel")
REPORTED = ("I2F", "I2FP", "F2I", "F2F", "FRND", "MUFU", "FCHK", "LDS",
            "LDC", "LDG", "BAR", "PRMT", "FADD", "FFMA", "FFMA_imm",
            "FFMA_cbank")

_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)")
_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_CBANK = re.compile(r"c\[0x[1-9a-f]\]")
_FLOAT_IMM = re.compile(r"(?<![\w.\[])-?\d+\.\d+(?:e[-+]?\d+)?\b")


def cuobjdump() -> str:
    """The toolkit's cuobjdump (beside nvcc), or RuntimeError."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "cuobjdump"
    if cand.exists():
        return str(cand)
    found = shutil.which("cuobjdump")
    if found is None:
        raise RuntimeError("cuobjdump not found (set CUDA_HOME)")
    return found


def dump(lib: Path) -> str:
    """The SASS of every kernel in the shared library `lib`."""
    return subprocess.run([cuobjdump(), "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout


def split_functions(sass: str) -> dict[str, list[str]]:
    """Mangled kernel name -> its SASS lines."""
    out: dict[str, list[str]] = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            cur = m.group(1)
            out[cur] = []
        elif cur is not None:
            out[cur].append(line)
    return out


def counts(lines: list[str]) -> dict[str, int]:
    """Opcode counts of one kernel's SASS lines, by base opcode (the name
    before the first '.'), plus FFMA_imm and FFMA_cbank."""
    c: collections.Counter = collections.Counter()
    for line in lines:
        m = _OPCODE.search(line)
        if not m:
            continue
        op = m.group(1).split(".")[0]
        c[op] += 1
        if op == "FFMA" and _FLOAT_IMM.search(line[m.end():]):
            c["FFMA_imm"] += 1
        if op == "FFMA" and _CBANK.search(line):
            c["FFMA_cbank"] += 1
    return dict(c)


def label(mangled: str) -> str:
    """A readable name of a kernel instantiation from its mangled name:
    'qim_embed_kernel<2, ArithHopper, 8>'."""
    s = mangled

    def name_at(i: int) -> tuple[str, int]:  # <length><identifier>
        d = re.match(r"\d+", s[i:])
        n, i = int(d.group()), i + d.end()
        return s[i:i + n], i + n

    if not s.startswith("_ZN"):
        return s
    i, names = 3, []
    while i < len(s) and s[i].isdigit():  # the namespace, then the kernel
        name, i = name_at(i)
        names.append(name)
    if not names or i >= len(s):
        return s
    if s[i] != "I":  # no template arguments
        return names[-1]
    i, args = i + 1, []
    while i < len(s) and s[i] != "E":
        if s[i] == "L":  # a literal, L<type><value>E
            j = s.index("E", i)
            args.append(s[i + 2:j])
            i = j + 1
        elif s[i] == "N":  # a nested type name: substitutions or names, then E
            i, last = i + 1, ""
            while i < len(s) and s[i] != "E":
                if s[i] == "S":
                    i = s.index("_", i) + 1
                elif s[i].isdigit():
                    last, i = name_at(i)
                else:
                    return s
            args.append(last)
            i += 1
        elif s[i].isdigit():
            name, i = name_at(i)
            args.append(name)
        else:
            return s
    return f"{names[-1]}<{', '.join(args)}>"


def ptxas(log: str) -> dict[str, tuple[int, int]]:
    """Registers and spill-store bytes of every kernel instantiation in
    nvcc's -Xptxas=-v report, by label()."""
    out: dict[str, tuple[int, int]] = {}
    name, spill = None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = label(m.group(1)), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), spill)
            name = None
    return out


def rows(lib: Path, kernels=DEFAULT_KERNELS, rn: int = 2) -> list[dict]:
    """One row per instantiation at `rn` of each kernel template named in
    `kernels`, or per kernel of that name that is no template: its label
    and the REPORTED counts (0 where absent)."""
    out = []
    for mangled, lines in sorted(split_functions(dump(lib)).items()):
        for k in kernels:
            if re.search(rf"{len(k)}{k}(?:ILi{rn}E|E)", mangled):
                c = counts(lines)
                out.append({"kernel": label(mangled),
                            **{op: c.get(op, 0) for op in REPORTED},
                            "instructions": sum(v for op, v in c.items()
                                                if not op.startswith("FFMA_"))})
    return out


def summary(rows_: list[dict]) -> str:
    """One line of the rows: 'name I2F=0 F2I=0 ...; name ...'."""
    keys = ("I2F", "I2FP", "F2I", "FRND", "MUFU", "FCHK", "LDS", "FFMA",
            "FFMA_imm", "FFMA_cbank", "PRMT")
    return "; ".join(f"{r['kernel']} " + " ".join(f"{k}={r[k]}" for k in keys)
                     for r in rows_)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Count the SASS opcodes of the "
                                 "stripe kernels in the built library.")
    ap.add_argument("--lib", default=None,
                    help="the library to read (default: this checkout's, "
                         "built first if stale)")
    ap.add_argument("--kernels", default=",".join(DEFAULT_KERNELS),
                    help="comma list of kernel template names")
    ap.add_argument("--rn", type=int, default=2,
                    help="slot rows of the instantiation (num_ac // 8 + 1)")
    args = ap.parse_args(argv)
    if args.lib is None:
        from stegotpu_torch.ops import _build

        _build.build()
        lib = _build.library_path()
    else:
        lib = Path(args.lib)
    found = rows(lib, tuple(args.kernels.split(",")), args.rn)
    for r in found:
        print(json.dumps({"lib": str(lib), **r}), flush=True)
    return 0 if found else 1


if __name__ == "__main__":
    sys.exit(main())
