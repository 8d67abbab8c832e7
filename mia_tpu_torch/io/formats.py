"""Output formatters for assemblies: ClustalW, line, column, diff-table,
FASTA, region view (plain/color/multi-FASTA), ACE and summary formats
(src/io.c:756-1085, src/map_align.c:543-849, src/map_alignment.c:107-278,635).

All writers stream to a file object (stdout by default) and are byte-faithful
to the reference's printf output.
"""
from __future__ import annotations

import sys

import numpy as np

from ..constants import CLUSTALW_LINE_WIDTH, FASTA_LINE_WIDTH, MAX_INS_LEN
from ..core.columns import find_ins_cons, main_column_counts
from ..core.types import MapAlignment
from ..ops.consensus import find_consensus_cols, find_phred_qscore


def fasta_print_cons(cons: str, seq_id: str, out=None) -> None:
    """FASTA output, dropping gaps, spaces -> X (src/io.c:929-951)."""
    out = out or sys.stdout
    out.write(f">{seq_id}\n")
    line = []
    for c in cons:
        if c == "-":
            continue
        line.append("X" if c == " " else c)
        if len(line) == FASTA_LINE_WIDTH:
            out.write("".join(line) + "\n")
            line = []
    out.write("".join(line) + "\n")


def fasta_aln_print(seq: str, seq_id: str, out=None) -> None:
    """Aligned FASTA output keeping gaps (src/io.c:953-973)."""
    out = out or sys.stdout
    out.write(f">{seq_id}\n")
    line = []
    for c in seq:
        line.append("X" if c == " " else c)
        if len(line) == FASTA_LINE_WIDTH:
            out.write("".join(line) + "\n")
            line = []
    out.write("".join(line) + "\n")


def clustalw_print_cons(cons: str, aln_ref: str, ref_id: str, out=None) -> None:
    """ClustalW-style block output (src/io.c:976-1029)."""
    out = out or sys.stdout
    ref_start = (ref_id[:15] + " " * 15)[:15] + "  "
    out.write("CLUSTAL W (1.8) multiple sequence alignment\n")
    ln = 0
    while ln * CLUSTALW_LINE_WIDTH < len(cons):
        ref_line = aln_ref[ln * CLUSTALW_LINE_WIDTH : (ln + 1) * CLUSTALW_LINE_WIDTH]
        cons_line = cons[ln * CLUSTALW_LINE_WIDTH : (ln + 1) * CLUSTALW_LINE_WIDTH]
        cons_line = cons_line.replace(" ", "X")
        out.write(f"{ref_start}{ref_line}\n")
        out.write(f"Consensus        {cons_line}\n")
        out.write("                 ")
        out.write(
            "".join(
                "*" if i < len(ref_line) and ref_line[i] == cons_line[i] else " "
                for i in range(len(cons_line))
            )
        )
        out.write("\n\n\n")
        ln += 1


def line_print_cons(cons: str, aln_ref: str, ref_id: str, cov, out=None) -> None:
    """One-line-each consensus/reference/coverage (src/io.c:1032-1042)."""
    out = out or sys.stdout
    out.write(f"Consensus, {ref_id}, coverage:\n")
    out.write(f"{cons}\n{aln_ref}\n")
    out.write("".join(f"{int(c)} " for c in cov[: len(cons)]))
    out.write("\n")


_COLOR = {
    "A": "\33[37;42m", "a": "\33[37;42m",
    "C": "\33[37;44m", "c": "\33[37;44m",
    "G": "\33[37;40m", "g": "\33[37;40m",
    "T": "\33[37;41m", "t": "\33[37;41m",
    "-": "\33[47;30m",
}


def color_print(s: str, out=None) -> None:
    """ANSI-colored sequence line (src/io.c:1044-1085)."""
    out = out or sys.stdout
    for c in s:
        out.write(_COLOR.get(c, "\33[0m"))
        out.write(c)
    out.write("\33[0m\n")


def show_single_pos(ref_pos, ref_base, cons_base, counts, scores, cov, frac, out=None):
    """13-column per-position diagnostics row (src/map_align.c:208-227)."""
    out = out or sys.stdout
    q = find_phred_qscore(scores)
    out.write(
        f"{ref_pos} {ref_base} {cons_base} {int(cov)} "
        f"{int(counts[0])} {int(counts[1])} {int(counts[2])} {int(counts[3])} "
        f"{int(counts[4])} "
        f"{int(scores[0])} {int(scores[1])} {int(scores[2])} {int(scores[3])} "
        f"{q} {frac:.3f}\n"
    )


def print_assembly_summary(maln: MapAlignment, out=None) -> None:
    """Header stats for the column format (src/map_alignment.c:635-653)."""
    out = out or sys.stdout
    total = sum(a.end - a.start + 1 for a in maln.aln_seqs)
    count = sum(1 for a in maln.aln_seqs if a.segment != "b")
    out.write(f"# Map reference ID: {maln.ref.id}\n")
    out.write(f"# Map reference length: {maln.ref.seq_len}\n")
    out.write(f"# Number of fragments aligned to reference: {count}\n")
    out.write(f"# Total length of aligned fragments: {total}\n")
    out.write(f"# Average coverage: {total / maln.ref.seq_len:.3f}\n")


def col_print_cons(cons, aln_ref, cov, ref_poss, maln: MapAlignment, out=None) -> None:
    """Column format with per-position strand start/end counts
    (src/map_align.c:761-849)."""
    out = out or sys.stdout
    length = maln.ref.seq_len
    starts_f = np.zeros(len(cons), dtype=np.int64)
    starts_r = np.zeros(len(cons), dtype=np.int64)
    ends_f = np.zeros(len(cons), dtype=np.int64)
    ends_r = np.zeros(len(cons), dtype=np.int64)
    for a in maln.aln_seqs:
        if a.revcom:
            if a.segment == "f":
                starts_r[a.start] += 1
            elif a.segment == "b":
                ends_r[a.end] += 1
            else:
                starts_r[a.start] += 1
                ends_r[a.end] += 1
        else:
            if a.segment == "f":
                starts_f[a.start] += 1
            elif a.segment == "b":
                ends_f[a.end] += 1
            else:
                starts_f[a.start] += 1
                ends_f[a.end] += 1
    out.write("# Columns:\n")
    out.write("# 1. Assembly consensus base\n")
    out.write(f"# 2. Reference {maln.ref.id} base\n")
    out.write("# 3. Coverage (number of reads overlapping this position)\n")
    out.write("# 4. Coordinate on reference sequence (1-based)\n")
    out.write("# 5. Number of fragments on forward strand that start here\n")
    out.write("# 6. Number of fragments on reverse strand that start here\n")
    out.write("# 7. Number of fragments on forward strand that end here\n")
    out.write("# 8. Number of fragments on reverse strand that end here\n")
    for i in range(len(cons)):
        if not (cons[i] == "-" and aln_ref[i] == "-"):
            c = "X" if cons[i] == " " else cons[i]
            rp = ref_poss[i]
            out.write(
                f"{c}\t{aln_ref[i]}\t{int(cov[i])}\t{rp + 1}\t"
                f"{int(starts_f[rp])}\t{int(starts_r[rp])}\t"
                f"{int(ends_f[rp])}\t{int(ends_r[rp])}\n"
            )


def build_aligned_consensus(maln: MapAlignment, out_format: int = 0, out=None):
    """Aligned consensus + reference + coverage arrays over ref columns and
    insertion columns (show_consensus core, src/map_alignment.c:107-183).
    When out_format is 4/41, streams the diff-table rows as it goes."""
    cc = main_column_counts(maln, exclude_dropped=False)
    cons_chars, fracs = find_consensus_cols(cc, maln.cons_code)
    consensus = []
    aln_ref = []
    cov = []
    ref_poss = []
    gaps = maln.ref.gaps
    for pos in range(maln.ref.seq_len):
        g = int(gaps[pos])
        if g > 0 and pos > 0:
            ins_chars, icc, ifr = find_ins_cons(maln, pos)
            for j in range(g):
                cj = chr(ins_chars[j])
                if out_format == 4 and cj != "-":
                    show_single_pos(
                        pos, "-", cj, icc.counts[j], icc.scores[j], icc.cov[j], ifr[j], out
                    )
                if out_format == 41:
                    show_single_pos(
                        pos, "-", cj, icc.counts[j], icc.scores[j], icc.cov[j], ifr[j], out
                    )
                aln_ref.append("-")
                consensus.append(cj)
                cov.append(int(icc.cov[j]))
                ref_poss.append(pos)
        cchar = chr(cons_chars[pos])
        rchar = maln.ref.seq[pos]
        if out_format == 4 and rchar != cchar:
            show_single_pos(
                pos, rchar, cchar, cc.counts[pos], cc.scores[pos], cc.cov[pos], fracs[pos], out
            )
        if out_format == 41:
            show_single_pos(
                pos, rchar, cchar, cc.counts[pos], cc.scores[pos], cc.cov[pos], fracs[pos], out
            )
        consensus.append(cchar)
        aln_ref.append(rchar)
        cov.append(int(cc.cov[pos]))
        ref_poss.append(pos)
    return "".join(consensus), "".join(aln_ref), cov, ref_poss


def show_consensus(maln: MapAlignment, out_format: int, out=None) -> None:
    """Format dispatch (src/map_alignment.c:107-220)."""
    out = out or sys.stdout
    consensus, aln_ref, cov, ref_poss = build_aligned_consensus(maln, out_format, out)
    if out_format == 1:
        clustalw_print_cons(consensus, aln_ref, maln.ref.id, out)
    elif out_format == 2:
        line_print_cons(consensus, aln_ref, maln.ref.id, cov, out)
    elif out_format == 3:
        print_assembly_summary(maln, out)
        col_print_cons(consensus, aln_ref, cov, ref_poss, maln, out)
    elif out_format == 5:
        fasta_print_cons(consensus, maln.ref.id, out)


def get_consensus(maln: MapAlignment) -> str:
    """Aligned consensus string incl. insertion columns, keeping gap chars
    (src/map_alignment.c:229-278)."""
    cc = main_column_counts(maln, exclude_dropped=False)
    cons_chars, _ = find_consensus_cols(cc, maln.cons_code)
    parts = []
    gaps = maln.ref.gaps
    for pos in range(maln.ref.seq_len):
        g = int(gaps[pos])
        if g > 0 and pos > 0:
            ins_chars, _, _ = find_ins_cons(maln, pos)
            parts.extend(chr(c) for c in ins_chars[:g])
        parts.append(chr(cons_chars[pos]))
    return "".join(parts)


def print_region(
    maln: MapAlignment, reg_start: int, reg_end: int, out_format: int,
    in_color: bool, out=None,
) -> None:
    """Region view: reference, consensus and all overlapping reads
    (src/map_align.c:543-759)."""
    out = out or sys.stdout
    reg_start = max(reg_start, 1)
    reg_end = min(reg_end, maln.ref.seq_len)

    cc = main_column_counts(maln, exclude_dropped=False)
    cons_chars, _ = find_consensus_cols(cc, maln.cons_code)
    gaps = maln.ref.gaps
    consensus = []
    aln_ref = []
    ins_cache: dict[int, np.ndarray] = {}
    for pos in range(reg_start - 1, reg_end):
        g = int(gaps[pos])
        if g > 0:
            ins_chars, _, _ = find_ins_cons(maln, pos)
            ins_cache[pos] = ins_chars
            for j in range(g):
                aln_ref.append("-")
                consensus.append(chr(ins_chars[j]))
        consensus.append(chr(cons_chars[pos]))
        aln_ref.append(maln.ref.seq[pos])
    consensus_s = "".join(consensus)
    aln_ref_s = "".join(aln_ref)

    if out_format == 61:
        fasta_aln_print(aln_ref_s, maln.ref.id, out)
        fasta_aln_print(consensus_s, "Consensus", out)
    elif in_color:
        out.write(f"{maln.ref.id[:20]:<20.20} ")
        color_print(aln_ref_s, out)
        out.write(f"{'Consensus':<20.20} ")
        color_print(consensus_s, out)
    else:
        out.write(f"{maln.ref.id[:20]:<20.20} {aln_ref_s}\n{'Consensus':<20} {consensus_s}\n")

    for a in maln.aln_seqs:
        if not (a.start <= reg_end - 1 and a.end >= reg_start - 1):
            continue
        flags = ("t" if a.trimmed else "_") + ("r" if a.revcom else "_") + f"{a.num_inputs:02d}"
        out_read_id = a.id + flags
        if out_format == 6:
            out.write(f"{out_read_id[:20]:<20.20} ")
        chunk: list[str] = []
        for pos in range(reg_start - 1, reg_end):
            g = int(gaps[pos])
            if a.start <= pos <= a.end:
                if g > 0:
                    ins = a.ins.get(pos - a.start)
                    ins_len = len(ins) if ins is not None else 0
                    if a.start == pos:
                        chunk.extend("." * g)
                    else:
                        if ins_len > 0:
                            chunk.extend(ins)
                        chunk.extend("-" * (g - ins_len))
                chunk.append(a.seq[pos - a.start])
            else:
                chunk.extend("." * g)
                chunk.append(".")
        read_str = "".join(chunk)
        if out_format == 61:
            fasta_aln_print(read_str, out_read_id, out)
        elif in_color:
            color_print(read_str, out)
        else:
            out.write(read_str + "\n")


def ace_output(maln: MapAlignment, out=None) -> None:
    """ACE assembly-format export (src/io.c:756-913)."""
    out = out or sys.stdout
    consensus = get_consensus(maln)
    number_of_reads = maln.num_aln_seqs
    number_bases = len(consensus)
    QUALITY_SCORE = 40
    max_line = 50

    def wrap_print(s: str) -> None:
        line = []
        for ch in s:
            line.append(ch)
            if len(line) == max_line:
                out.write("".join(line) + "\n")
                line = []
        out.write("".join(line) + "\n")

    out.write(f"AS 1 {number_of_reads + 1}\n\n")
    out.write(f"CO {maln.ref.id} {number_bases} {number_of_reads + 1} 1 U\n")
    wrap_print(
        "".join("*" if c == "-" else ("X" if c == " " else c) for c in consensus)
    )
    out.write("\n")

    out.write("BQ\n")
    for i, c in enumerate(consensus):
        if c != "-":
            out.write(f"{QUALITY_SCORE} ")
        if i % max_line == 0:
            out.write("\n")
    out.write("\n\n")

    gaps = maln.ref.gaps

    def sum_of_gaps(pos: int) -> int:
        return int(np.sum(gaps[:pos]))

    out.write("AF FAKE_READ-IGNORE_ME U 1\n")
    for a in maln.aln_seqs:
        out.write(
            f"AF {a.id} {'C' if a.revcom else 'U'} {a.start + sum_of_gaps(a.start) + 1}\n"
        )
    out.write("\n")
    out.write(f"BS 1 {len(consensus)} FAKE_READ-IGNORE_ME\n\n")

    for a in maln.aln_seqs:
        g = int(np.sum(gaps[a.start : a.end + 1]))
        out.write(f"RD {a.id} {len(a.seq) + g} 0 0\n")
        seq_chars: list[str] = []
        for pos in range(a.start, a.end + 1):
            gp = int(gaps[pos]) if pos < len(gaps) else 0
            if gp > 0:
                ins = a.ins.get(pos - a.start)
                ins_len = len(ins) if ins is not None else 0
                for n in range(gp):
                    seq_chars.append(ins[n] if n < ins_len else "*")
            if pos - a.start < len(a.seq):
                seq_chars.append(a.seq[pos - a.start])
        wrap_print("".join("*" if c == "-" else c for c in seq_chars))
        out.write("\n")
        out.write(f"QA 1 {len(a.seq) + g} 1 {len(a.seq) + g}\n")
        out.write(
            f"DS CHROMAT_FILE: {a.id} PHD_FILE: {a.id}_FAKE.phd "
            "TIME: Tue Feb 21 15:42:35 1984\n\n"
        )

    out.write(f"RD FAKE_READ-IGNORE_ME {number_bases} 0 0\n")
    wrap_print(
        "".join("*" if c == "-" else ("X" if c == " " else c) for c in consensus)
    )
    out.write("\n\n")
    out.write(f"QA 1 {number_bases} 1 {number_bases}\n")
    out.write(
        "DS CHROMAT_FILE: FAKE_READ PHD_FILE: FAKE_READ_FAKE.phd "
        "TIME: Tue Feb 21 23:23:23 1984\n"
    )
