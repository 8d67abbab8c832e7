"""maln (MapAlignment) serialization, byte-compatible with the reference.

The maln text file is the de-facto checkpoint format of the whole tool family:
``mia`` writes one per iteration, ``ma`` and ``ccheck`` resume from it
(write_ma src/map_alignment.c:283-382, read_ma src/map_alignment.c:384-611).
Layout: header line with version + asctime stamp, MALN_* counts, reference
(ID/DESC/LEN/SIZE/SEQ/GAPS), both PSSMs (31 5x5 blocks each), then per-read
records ID/DESC/SCORE/NUM_INPUTS/START/END/RC/TR/DR/SEG/SEQ/SMP/INS_POS.
The reader tolerates files missing NUM_INPUTS and DR (older writers).
"""
from __future__ import annotations

import re
import time

import numpy as np

from ..constants import PACKAGE_VERSION, PSSM_DEPTH
from ..core.types import AlnSeq, MapAlignment, RefSeq


def _format_pssm(sm: np.ndarray) -> str:
    out = []
    for d in range(2 * PSSM_DEPTH + 1):
        for row in range(5):
            out.append(" ".join(str(int(v)) for v in sm[d, row]))
        out.append("")
    return "\n".join(out)


def header_lines(
    maln: MapAlignment,
    *,
    timestamp: float | None = None,
    nas: int | None = None,
    siz: int | None = None,
) -> list[str]:
    """Everything before the record blocks (src/map_alignment.c:283-336);
    ``nas``/``siz`` override the local counts for the multi-host writer."""
    t = time.localtime(timestamp if timestamp is not None else time.time())
    lines: list[str] = []
    lines.append(f"/* map_alignment [V{PACKAGE_VERSION}] */ {time.asctime(t)}")
    lines.append(f"MALN_NAS {maln.num_aln_seqs if nas is None else nas}")
    lines.append(f"MALN_SIZ {maln.size if siz is None else siz}")
    lines.append(f"MALN_COC {maln.cons_code}")
    lines.append("__REFERENCE__")
    lines.append(f"ID {maln.ref.id}")
    lines.append(f"DESC {maln.ref.desc}")
    lines.append(f"LEN {maln.ref.seq_len}")
    lines.append(f"SIZE {maln.ref.size}")
    lines.append("SEQ " + maln.ref.seq[: maln.ref.seq_len])
    gaps = maln.ref.gaps
    lines.append("GAPS" + "".join(f" {int(gaps[i])}" for i in range(maln.ref.seq_len)))
    lines.append("__PSSM__")
    lines.append(f"DEPTH {PSSM_DEPTH}")
    lines.append("FPSM:")
    lines.append(_format_pssm(maln.fpsm))
    lines.append("RPSM:")
    lines.append(_format_pssm(maln.rpsm))
    lines.append("__ALNSEQS__")
    return lines


def write_ma(path: str, maln: MapAlignment, *, timestamp: float | None = None) -> None:
    """Serialize ``maln`` exactly as the reference's write_ma
    (src/map_alignment.c:283-382)."""
    with open(path, "w") as fh:
        # blocked writes: byte-identical to one giant join, without
        # materialising a ~60 MB line list (page-fault surface, see
        # utils/hostmem.py)
        buf = header_lines(maln, timestamp=timestamp)
        for a in maln.aln_seqs:
            buf.extend(alnseq_lines(a))
            if len(buf) >= 65536:
                fh.write("\n".join(buf) + "\n")
                buf.clear()
        if buf:
            fh.write("\n".join(buf) + "\n")


def alnseq_lines(a) -> list[str]:
    """The record block write_ma emits for one AlnSeq
    (src/map_alignment.c:338-378); shared with the multi-host global
    writer."""
    lines = [
        f"ID {a.id}",
        f"DESC {a.desc}",
        f"SCORE {a.score}",
        f"NUM_INPUTS {a.num_inputs}",
        f"START {a.start}",
        f"END {a.end}",
        f"RC {1 if a.revcom else 0}",
        f"TR {1 if a.trimmed else 0}",
        f"DR {1 if a.dropped else 0}",
        f"SEG {a.segment}",
        f"SEQ {a.seq}",
        f"SMP {a.smp}",
    ]
    if a.ins:
        n = len(a.seq)
        lines.append(
            "INS_POS"
            + "".join(f" {j} {a.ins[j]}" for j in sorted(a.ins) if 0 <= j < n)
        )
    else:
        lines.append("INS_POS")
    return lines


def read_ma(path: str) -> MapAlignment:
    """Parse a maln file (read_ma, src/map_alignment.c:384-611), tolerating
    missing NUM_INPUTS/DR fields."""
    with open(path) as fh:
        text = fh.read()
    lines = text.split("\n")
    it = iter(lines)

    def nx() -> str:
        return next(it)

    header = nx()
    if "/* map_alignment" not in header:
        raise ValueError(f"{path} does not look like a map_alignment input file")
    maln = MapAlignment()
    maln.ref = RefSeq()
    m = re.match(r"MALN_NAS (\d+)", nx())
    num_aln_seqs = int(m.group(1))
    m = re.match(r"MALN_SIZ (\d+)", nx())
    size = int(m.group(1))
    # reference grows its array by doubling from 16000 until >= size
    maln.size = 16000
    while maln.size < size:
        maln.size *= 2
    m = re.match(r"MALN_COC (\d+)", nx())
    maln.cons_code = int(m.group(1))
    if "__REFERENCE__" not in nx():
        raise ValueError(f"Do not see reference sequence header in {path}")
    id_toks = nx()[3:].split()
    maln.ref.id = id_toks[0] if id_toks else ""
    desc_line = nx()
    # reference uses sscanf("DESC %s") -> first token only
    toks = desc_line[5:].split()
    maln.ref.desc = toks[0] if toks else ""
    maln.ref.seq_len = int(nx().split()[1])
    maln.ref.size = int(nx().split()[1])
    maln.ref.seq = nx()[4:].split()[0]
    if len(maln.ref.seq) != maln.ref.seq_len:
        raise ValueError("Reported length of reference sequence is not observed length")
    gap_line = nx()
    gvals = gap_line[4:].split()
    maln.ref.gaps = np.zeros(maln.ref.seq_len + 1, dtype=np.int64)
    maln.ref.gaps[: maln.ref.seq_len] = [int(v) for v in gvals[: maln.ref.seq_len]]
    maln.ref.wrap_seq_len = maln.ref.seq_len
    if "__PSSM__" not in nx():
        raise ValueError(f"Do not see __PSSM__ line in {path}")
    depth = int(nx().split()[1])
    if "FPSM:" not in nx():
        raise ValueError(f"Do not see the FPSM: in {path}")

    def read_pssm_block() -> np.ndarray:
        sm = np.zeros((2 * depth + 1, 5, 5), dtype=np.int32)
        for d in range(2 * depth + 1):
            for row in range(5):
                sm[d, row] = [int(v) for v in nx().split()[:5]]
            nx()  # blank separator
        return sm

    maln.fpsm = read_pssm_block()
    if "RPSM:" not in nx():
        raise ValueError(f"Do not see the RPSM: in {path}")
    maln.rpsm = read_pssm_block()
    if "__ALNSEQS__" not in nx():
        raise ValueError(f"Do not see __ALNSEQS__ line in {path}")

    records: list[AlnSeq] = []
    for _ in range(num_aln_seqs):
        a = AlnSeq()
        a.id = nx()[3:].split()[0]
        dl = nx()
        a.desc = dl[5:]
        a.score = int(nx().split()[1])
        line = nx()
        if line.startswith("NUM_INPUTS"):
            a.num_inputs = int(line.split()[1])
            line = nx()
        else:
            a.num_inputs = 1
        a.start = int(line.split()[1])
        a.end = int(nx().split()[1])
        a.revcom = bool(int(nx().split()[1]))
        a.trimmed = bool(int(nx().split()[1]))
        line = nx()
        if line.startswith("DR"):
            a.dropped = bool(int(line.split()[1]))
            line = nx()
        a.segment = line.split()[1]
        seq_toks = nx()[4:].split()
        a.seq = seq_toks[0] if seq_toks else ""
        smp_toks = nx()[4:].split()
        a.smp = smp_toks[0] if smp_toks else ""
        ins_line = nx()
        a.ins = {}
        toks = ins_line[len("INS_POS"):].split()
        for k in range(0, len(toks) - 1, 2):
            a.ins[int(toks[k])] = toks[k + 1]
        records.append(a)
    maln.set_aln_seqs(records)
    return maln
