"""Legacy Stenzel-align input: pairwise alignments against a common target
(read_align_aln, src/io.c:515-750; ses_from_align_desc,
src/map_align.c:964-999; adapt_from_desc, src/map_align.c:1006-1017).

Each record is two FASTA-style entries — the aligned reference fragment
(description "<strand> <start>-<end> score=<s> [<segment>]") followed by the
aligned read — both gapped to equal length.  Minus-strand records revcom
both strings; leading/trailing reference-gap context is stripped with the
coordinates adjusted; a leading '-' on the read description flips the revcom
flag.
"""
from __future__ import annotations

import re
import sys
from typing import Iterator

from ..constants import INIT_ALN_SEQ_LEN, MAX_DESC_LEN, MAX_ID_LEN
from ..core.merge import revcom_PWAF
from ..core.types import PWAlnFrag


def ses_from_align_desc(pwaln: PWAlnFrag) -> int | None:
    """Parse '<strand> <start>-<end> score=<s> [<seg>]' from ref_desc;
    returns the strand (+1/-1) or None on failure."""
    pwaln.segment = "n"
    m = re.match(
        r"\s*(\S)\s+(\d+)-(\d+)\s+score=(\S+)(?:\s+(\S))?", pwaln.ref_desc
    )
    if not m:
        return None
    strand_char = m.group(1)
    pwaln.start = int(m.group(2)) - 1
    pwaln.end = int(m.group(3)) - 1
    score = m.group(4)
    if m.group(5):
        pwaln.segment = m.group(5)
    if score.startswith("-"):
        digits = re.match(r"-?(\d+)", score)
        pwaln.score = -int(digits.group(1)) if digits else 0
    else:
        digits = re.match(r"(\d+)", score)
        pwaln.score = int(digits.group(1)) if digits else 0
    if strand_char == "+":
        return 1
    if strand_char == "-":
        return -1
    return None


def adapt_from_desc(pwaln: PWAlnFrag) -> None:
    pwaln.trimmed = "adapter cut off" in pwaln.frag_desc


def _read_entry(lines: list[str], i: int) -> tuple[str, str, str, int] | None:
    """(id, desc, gapped_seq, next_index) starting at the next '>' header."""
    n = len(lines)
    while i < n and not lines[i].startswith(">"):
        i += 1
    if i >= n:
        return None
    header = lines[i][1:]
    parts = header.split(None, 1)
    seq_id = (parts[0] if parts else "")[:MAX_ID_LEN]
    desc = (parts[1] if len(parts) > 1 else "")[:MAX_DESC_LEN]
    i += 1
    chunks = []
    while i < n and not lines[i].startswith(">"):
        chunks.append(lines[i].replace(" ", ""))
        i += 1
    return seq_id, desc, "".join(chunks).upper(), i


def iter_align_aln(path: str) -> Iterator[PWAlnFrag]:
    """Yield PWAlnFrag records from a Stenzel-align file."""
    with open(path) as fh:
        lines = fh.read().split("\n")
    i = 0
    while True:
        ref = _read_entry(lines, i)
        if ref is None:
            return
        frag = _read_entry(lines, ref[3])
        if frag is None:
            return
        i = frag[3]

        af = PWAlnFrag()
        af.ref_id, af.ref_desc, af.ref_seq = ref[0], ref[1], ref[2]
        af.frag_id, af.frag_desc, af.frag_seq = frag[0], frag[1], frag[2]

        if max(len(af.ref_seq), len(af.frag_seq)) > INIT_ALN_SEQ_LEN:
            print(f"Aligned sequence {af.frag_id} is too big", file=sys.stderr)
            return
        if len(af.frag_seq) != len(af.ref_seq):
            print(
                f"Cannot use {af.frag_id}: ref and frag alignments are "
                "unequal lengths",
                file=sys.stderr,
            )
            af.score = -1
            yield af
            continue

        strand = ses_from_align_desc(af)
        if strand is None:
            raise ValueError(
                f"Problem getting start, end, strand from {af.ref_desc}"
            )
        adapt_from_desc(af)

        if strand == -1:
            revcom_PWAF(af)
            af.revcom = True
        else:
            af.revcom = False

        # strip leading/trailing read-gap context and adjust the reference
        # coordinates.  The reference counts the gap runs before revcom and
        # swaps them afterwards; measuring on the current (possibly
        # revcom'ed) strings gives the same result: start moves by the
        # current leading run, end by the current trailing run.
        lead = len(af.frag_seq) - len(af.frag_seq.lstrip("-"))
        trail = len(af.frag_seq) - len(af.frag_seq.rstrip("-"))
        aln_len = len(af.ref_seq) - lead - trail
        af.ref_seq = af.ref_seq[lead : lead + aln_len]
        af.frag_seq = af.frag_seq[lead : lead + aln_len]
        af.start += lead
        af.end -= trail

        if af.frag_desc.startswith("-"):
            af.revcom = not af.revcom
        yield af
