"""Pairwise-alignment -> multi-alignment merge and circular bookkeeping.

Covers merge_pwaln_into_maln (src/map_align.c:866-954), split_pwaln
(src/map_align.c:1376-1438), c2rcc (src/mia.c:26-30), revcom_PWAF
(src/map_align.c:512-535) and add_ref_wrap (src/mia.c:657-689).
"""
from __future__ import annotations

import numpy as np

from ..constants import INIT_ALN_SEQ_LEN, MAX_ID_LEN
from ..core.types import AlnSeq, MapAlignment, PWAlnFrag, RefSeq
from ..utils.encoding import revcom


def c2rcc(c: int, length: int) -> int:
    """Coordinate on the reverse complement, wrap-aware (src/mia.c:26-30)."""
    return length - (c % length) - 1


def revcom_PWAF(pwaln: PWAlnFrag) -> None:
    """Reverse-complement both gapped strings of a pairwise fragment."""
    pwaln.ref_seq = revcom(pwaln.ref_seq)
    pwaln.frag_seq = revcom(pwaln.frag_seq)
    pwaln.revcom = True


def add_ref_wrap(ref: RefSeq) -> None:
    """Append min(256, len) bp from the start to the end of the reference
    (and its revcom) so circular alignments can cross the origin
    (src/mia.c:657-689).  Tracks the reference's size-doubling for maln SIZE
    parity."""
    wrap_len = min(ref.seq_len, INIT_ALN_SEQ_LEN)
    while (ref.seq_len + wrap_len) >= ref.size:
        ref.size *= 2
    ref.seq = ref.seq[: ref.seq_len] + ref.seq[:wrap_len]
    if ref.rcseq is not None:
        ref.rcseq = ref.rcseq[: ref.seq_len] + ref.rcseq[:wrap_len]
    ref.wrap_seq_len = wrap_len + ref.seq_len
    ref.circular = True


def split_pwaln(front: PWAlnFrag, wrap_point: int) -> PWAlnFrag:
    """Split an origin-crossing alignment into front/back segments with
    ``_f``/``_b`` id suffixes (src/map_align.c:1376-1438).  Returns the back
    fragment; ``front`` is modified in place."""
    back = PWAlnFrag()
    ref_pos = front.start
    frag_pos = 0
    aln_pos = 0

    base_id = front.frag_id[: MAX_ID_LEN - 2]
    front.frag_id = base_id + "_f"
    back.frag_id = base_id + "_b"

    while ref_pos < wrap_point:
        if front.ref_seq[aln_pos] != "-":
            ref_pos += 1
        if front.frag_seq[aln_pos] != "-":
            frag_pos += 1
        aln_pos += 1

    back.ref_seq = front.ref_seq[aln_pos:]
    back.frag_seq = front.frag_seq[aln_pos:]
    front.ref_seq = front.ref_seq[:aln_pos]
    front.frag_seq = front.frag_seq[:aln_pos]

    back.start = 0
    back.end = front.end
    front.end = wrap_point - 1
    back.segment = "b"
    front.segment = "f"
    back.offset = frag_pos
    back.ref_id = front.ref_id
    back.ref_desc = front.ref_desc
    back.frag_desc = front.frag_desc
    back.revcom = front.revcom
    back.trimmed = front.trimmed
    back.score = front.score
    back.num_inputs = front.num_inputs
    return back


def merge_pwaln_into_maln(pwaln: PWAlnFrag, maln: MapAlignment) -> AlnSeq:
    """Insert a pairwise alignment into the multi-alignment: strip read gaps
    into per-position insert strings and bump the shared per-column
    max-insert array (src/map_align.c:866-954).

    Reuses the next pool slot in place; note ``dropped`` and ``smp`` are
    deliberately NOT reset, matching the reference's field-by-field copy."""
    asp = maln.next_slot()
    asp.id = pwaln.frag_id
    asp.desc = pwaln.frag_desc
    asp.score = pwaln.score
    asp.start = pwaln.start
    asp.end = pwaln.end
    asp.revcom = pwaln.revcom
    asp.trimmed = pwaln.trimmed
    asp.segment = pwaln.segment
    asp.num_inputs = pwaln.num_inputs

    # fast path: most reads align with no reference gaps — a C-level substr
    # scan beats two numpy conversions at typical (~60 bp) read lengths
    if "-" not in pwaln.ref_seq:
        asp.seq = pwaln.frag_seq
        asp.ins = {}
        return asp

    rb = np.frombuffer(pwaln.ref_seq.encode("latin-1"), np.uint8)
    is_gap = rb == ord("-")
    fb = np.frombuffer(pwaln.frag_seq.encode("latin-1"), np.uint8)
    nongap = ~is_gap
    # seq position (count of preceding ref non-gaps) of every column
    pos = np.cumsum(nongap) - nongap
    asp.seq = fb[nongap].tobytes().decode("latin-1")
    seq_len = len(asp.seq)

    # consecutive ref-gap columns share a pos, so each gap run is one unique
    # pos; a trailing run (pos == seq_len) is dropped exactly like the
    # reference (the final '\0' is only written on the next non-gap, which
    # never comes)
    gp = pos[is_gap]
    gap_chars = fb[is_gap]
    uniq_pos, offs = np.unique(gp, return_index=True)
    bounds = np.append(offs, len(gap_chars))
    ins: dict[int, str] = {}
    for j, p in enumerate(uniq_pos):
        if p < seq_len:
            ins[int(p)] = gap_chars[bounds[j] : bounds[j + 1]].tobytes().decode(
                "latin-1"
            )
    asp.ins = ins

    gaps = maln.ref.gaps
    ref_frag_len = asp.end - asp.start + 1
    counts = np.diff(bounds)
    sel = uniq_pos < ref_frag_len
    if sel.any():
        np.maximum.at(gaps, asp.start + uniq_pos[sel], counts[sel])
    return asp
