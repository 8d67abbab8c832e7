"""easy-consensus: percent-threshold consensus of a multi-FASTA panel into
IUPAC codes (port of misc/easy-consensus.hs) — the tool that produces panel
consensus inputs like the bundled mt311.

Per column: count A,C,G,T,'-'; take the most common states until the chosen
fraction of counted characters is covered; collapse the taken set into an
IUPAC code, lowercase when '-' is in the set (an "optional gap").  Columns
whose counted total is zero collapse to 'A' exactly like the Haskell original
(its span over an all-zero cumulative list keeps the first entry).
"""
from __future__ import annotations

import math
import sys

_AMBI = {
    "": "-", "A": "A", "AC": "M", "ACG": "V", "ACGT": "N", "ACT": "H",
    "AG": "R", "AGT": "D", "AT": "W", "C": "C", "CG": "S", "CGT": "B",
    "CT": "Y", "G": "G", "GT": "K", "T": "T",
    "-": "-", "-A": "a", "-AC": "m", "-ACG": "v", "-ACGT": "n", "-ACT": "h",
    "-AG": "r", "-AGT": "d", "-AT": "w", "-C": "c", "-CG": "s", "-CGT": "b",
    "-CT": "y", "-G": "g", "-GT": "k", "-T": "t",
}


def to_ambicode(s: str) -> str:
    return _AMBI[s]


def to_nucleotide(s: str) -> str:
    if len(s) == 1 and s in "ACGT-":
        return s
    if not s:
        return "-"
    return "N"


def read_mfasta(text: str) -> list[str]:
    seqs: list[str] = []
    cur: list[str] | None = None
    for line in text.replace("\r", "").split("\n"):
        if line.startswith(">"):
            if cur is not None:
                seqs.append("".join(cur))
            cur = []
        elif cur is not None:
            cur.append(line)
    if cur is not None:
        seqs.append("".join(cur))
    return seqs


def call_cons(column: str, percent: float, ambicode) -> str:
    """Consensus of one (already uppercased) column (call_cons,
    misc/easy-consensus.hs:83-99)."""
    counts = {b: 0 for b in "ACGT-"}
    for ch in column:
        if ch in counts:
            counts[ch] += 1
    # stable descending sort keeps A,C,G,T,- order on ties
    order = sorted("ACGT-", key=lambda b: -counts[b])
    total = sum(counts.values())
    need = math.ceil(percent * total)
    taken: list[str] = []
    cum = 0
    for b in order:
        taken.append(b)
        cum += counts[b]
        if cum >= need:
            break
    return ambicode("".join(sorted(taken)))


def consensus(seqs: list[str], percent: float, ambicode) -> str:
    """Ragged transpose (columns draw from every sequence still long enough,
    like Haskell's transpose) then per-column call."""
    if not seqs:
        return ""
    out = []
    for i in range(max(len(s) for s in seqs)):
        col = "".join(s[i].upper() for s in seqs if i < len(s))
        out.append(call_cons(col, percent, ambicode))
    return "".join(c for c in out if c != "-")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    percent = 1.0
    ambicode = to_ambicode
    out_fn = None
    files: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-p", "--percent"):
            i += 1
            percent = float(argv[i]) / 100.0
        elif a.startswith("--percent="):
            percent = float(a.split("=", 1)[1]) / 100.0
        elif a in ("-n", "--only-n"):
            ambicode = to_nucleotide
        elif a in ("-i", "--iupac"):
            ambicode = lambda s: to_ambicode(s).upper()  # noqa: E731
        elif a in ("-g", "--gaps"):
            ambicode = to_ambicode
        elif a in ("-o", "--output"):
            i += 1
            out_fn = argv[i]
        elif a in ("-h", "-?", "--help", "--usage"):
            sys.stderr.write(
                "Usage: easy-consensus [options...] [fasta-file]\n"
                "Reads a multi-FastA file, computes a consensus where a given\n"
                "fraction of the sequences agree, writes it out in FastA format.\n"
                "  -p P  percentage needed for consensus\n"
                "  -n    only nucleotides and N\n  -i    all IUPAC codes\n"
                "  -g    IUPAC codes + small letters for optional gaps\n"
                "  -o F  write output to F\n"
            )
            return 0
        else:
            files.append(a)
        i += 1

    seqs: list[str] = []
    for fn in files:
        text = sys.stdin.read() if fn == "-" else open(fn).read()
        seqs.extend(read_mfasta(text))
    cons = consensus(seqs, percent, ambicode)
    lines = [">consensus"] + [cons[i : i + 60] for i in range(0, len(cons), 60)]
    body = "\n".join(lines) + "\n"
    if out_fn and out_fn != "-":
        with open(out_fn, "w") as f:
            f.write(body)
    else:
        sys.stdout.write(body)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
