"""Count the machine instructions of a CUDA kernel's loops.

    python -m mia_tpu_torch.utils.sass [--out DIR] [-D NAME=VALUE ...] [source.cu | kept.sass ...]

Compiles each source (default: every ``mia_tpu_torch/csrc/*.cu``) to a cubin
with the port's own ``nvcc`` flags, disassembles it with ``cuobjdump -sass``
and prints, per kernel, its instruction count and every loop (a backward
branch and its target) with the instructions between them and the most
frequent opcodes of the largest one.  With ``--out`` the disassembly is kept
there.  For the entry scorer the largest loop is the row loop: its count
over the cells of one trip (12 columns a lane, times the rows a trip covers)
is the instructions a DP cell costs; a loop that holds exclusive branches
(the ``-h`` candidates) is counted whole, so its figure is an upper bound.
A device function compiled out of line (``csrc/dp_band.cu``'s
``band_row_warps<kHp, G>``, the rows of G = 2, 4 and 8 warps) follows its
kernel's code under the kernel's name: each is reported apart, from the
addresses the kernel's ``CALL`` instructions target, its loops with it, and
the kernel's own row loop is then the one-warp rows'.  The strand forms
(``csrc/dp_strand.cu``, ``dp_strand_kernel<false>`` and ``<true>``) have
one row loop each, two DP rows a trip over 9 columns a thread.  ``-D``
defines a macro for the compile: ``-D MIA_HP_KIND=k`` builds
``csrc/dp_band.cu`` and ``csrc/dp_strand.cu`` with every row of one ``-h``
kind (0 none, 1 hp_col, 2 hp_row), so that each ``-h`` row loop is that
kind's alone.
Needs the CUDA toolkit; no card.
"""
from __future__ import annotations

import collections
import glob
import os
import re
import subprocess
import sys
import tempfile

from .torchcfg import CSRC_DIR, NVCC_FLAGS, _nvcc

_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?);")


def disassemble(source: str, defines: tuple[str, ...] = ()) -> str:
    """``cuobjdump -sass`` of ``source`` compiled alone with the port's flags
    and ``-D`` each of ``defines``."""
    nvcc = _nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as d:
        cubin = os.path.join(d, "k.cubin")
        flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        flags += [f"-D{d}" for d in defines]
        subprocess.run([nvcc, *flags, "-cubin", "-o", cubin, source], check=True,
                       capture_output=True, text=True)
        return subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout


def kernels(sass: str) -> dict[str, list[tuple[int, str]]]:
    """Kernel name -> its (address, instruction text) list."""
    out: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def opcode(text: str) -> str:
    """The opcode of an instruction without predicate and modifiers."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def loops(instrs: list[tuple[int, str]]) -> list[tuple[int, int, int]]:
    """(target, branch address, instructions between them inclusive) of each
    predicated backward branch, largest first.  An unconditional branch
    back is the return from an out-of-line block (the compiler's path for
    a shuffle under divergence), not a loop."""
    addrs = [a for a, _ in instrs]
    found = []
    for addr, text in instrs:
        m = re.search(r"^@!?U?P\d+ BRA\b.*\b0x([0-9a-f]+)\s*$", text)
        if m and int(m.group(1), 16) <= addr:
            target = int(m.group(1), 16)
            found.append((target, addr, sum(1 for a in addrs if target <= a <= addr)))
    return sorted(found, key=lambda t: -t[2])


def bodies(instrs: list[tuple[int, str]]) -> list[tuple[str, int, int]]:
    """(label, first address, end address) of a kernel's own code and of each
    device function it calls out of line (``CALL`` targets): cuobjdump lists
    the callees after the kernel's code under its name."""
    starts = sorted({int(m.group(1), 16) for _, t in instrs
                     for m in [re.search(r"\bCALL\.\S*\s+0x([0-9a-f]+)", t)] if m})
    end = instrs[-1][0] + 1 if instrs else 0
    edges = [instrs[0][0] if instrs else 0, *starts, end]
    labels = ["kernel", *(f"callee at {a:#06x}" for a in starts)]
    return [(lab, lo, hi) for lab, lo, hi in zip(labels, edges, edges[1:])]


def report(source: str, out_dir: str | None, defines: tuple[str, ...] = ()) -> None:
    if source.endswith(".sass"):  # a disassembly kept by an earlier run
        with open(source) as f:
            sass, out_dir = f.read(), None
    else:
        sass = disassemble(source, defines)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, os.path.basename(source) + ".sass"), "w") as f:
            f.write(sass)
    for name, instrs in kernels(sass).items():
        real = [(a, t) for a, t in instrs if opcode(t) != "NOP"]
        print(f"{os.path.basename(source)} {name}: {len(real)} instructions")
        parts = bodies(real)
        for label, lo, hi in parts:
            body = [(a, t) for a, t in real if lo <= a < hi]
            if len(parts) > 1:
                print(f"  {label}: {len(body)} instructions")
            for k, (target, addr, n) in enumerate(loops(body)):
                print(f"  loop {target:#06x}..{addr:#06x}: {n} instructions")
                if k == 0:
                    hist = collections.Counter(opcode(t) for a, t in body if target <= a <= addr)
                    print("    " + ", ".join(f"{op} {c}" for op, c in hist.most_common(24)))


def main(argv: list[str]) -> int:
    out_dir, defines = None, []
    while argv[:1] in (["--out"], ["-D"]):
        if argv[0] == "--out":
            out_dir = argv[1]
        else:
            defines.append(argv[1])
        argv = argv[2:]
    for source in argv or sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))):
        report(source, out_dir, tuple(defines))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
