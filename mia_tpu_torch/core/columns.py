"""Column-wise consensus over a MapAlignment.

Bridges the assembly state to the vectorised consensus ops: one scatter-add
pass builds every main-column accumulator (vs the reference's O(ref_len *
num_reads) rescans, src/mia.c:551-599 / src/map_alignment.c:134-183), and
one more builds every insertion column's, laid end to end (find_ins_cons,
src/map_align.c:444-510, for all gap positions at once).
"""
from __future__ import annotations

import numpy as np

from ..ops.consensus import ColumnCounts, find_consensus_cols
from .types import MapAlignment


def _record_arrays(maln: MapAlignment, exclude_dropped: bool):
    """Arena-layout arrays of the live records (shared by the host and
    device accumulators); None when there are no records."""
    recs = [
        a
        for a in maln.aln_seqs
        if not (exclude_dropped and a.dropped)
        and min(a.end - a.start + 1, len(a.seq), len(a.smp)) > 0
    ]
    if not recs:
        return None
    # int32 throughout: at ~30 us/page first-touch on this host (see
    # utils/hostmem.py) the index arrays' memory footprint IS the cost
    spans = np.fromiter(
        (min(a.end - a.start + 1, len(a.seq), len(a.smp)) for a in recs),
        np.int32,
        len(recs),
    )
    starts = np.fromiter((a.start for a in recs), np.int32, len(recs))
    revs = np.fromiter((a.revcom for a in recs), bool, len(recs))
    seq_arena = np.frombuffer(
        "".join(a.seq for a in recs).encode("latin-1"), np.uint8
    )
    smp_arena = np.frombuffer(
        "".join(a.smp for a in recs).encode("latin-1"), np.uint8
    )
    seq_lens = np.fromiter((len(a.seq) for a in recs), np.int32, len(recs))
    smp_lens = np.fromiter((len(a.smp) for a in recs), np.int32, len(recs))
    seq_off = np.concatenate(([0], np.cumsum(seq_lens, dtype=np.int32)[:-1]))
    smp_off = np.concatenate(([0], np.cumsum(smp_lens, dtype=np.int32)[:-1]))
    return recs, spans, starts, revs, seq_arena, smp_arena, seq_off, smp_off


def main_column_counts(
    maln: MapAlignment, exclude_dropped: bool, device_hook=None
) -> ColumnCounts:
    """Accumulate BaseCounts for every reference column in one pass (the
    reference rescans every read per column, O(ref_len * reads),
    src/mia.c:551-599; here it is O(total aligned bases)).

    ``exclude_dropped`` mirrors the difference between mia's consensus
    (skips dropped reads, src/mia.c:580-582) and ma's (does not,
    src/map_alignment.c:154-168).

    ``device_hook(seq, smp, starts, spans, seq_off, smp_off, revs, fpsm,
    rpsm, n) -> (counts, cov, scores)`` runs the accumulation on the TPU
    (ops/consensus_device.py, via the resident server or an in-process
    mesh); integer scatter-adds are order-independent so the device result
    is bit-equal, and any failure falls back to the host path.
    """
    n = maln.ref.seq_len
    cc = ColumnCounts(n)
    arrays = _record_arrays(maln, exclude_dropped)
    if arrays is None:
        return cc
    recs, spans, starts, revs, seq_arena, smp_arena, seq_off, smp_off = arrays
    if device_hook is not None:
        from ..utils import profiling

        try:
            with profiling.phase("consensus.device_counts"):
                counts, cov, scores = device_hook(
                    seq_arena, smp_arena, starts, spans, seq_off, smp_off,
                    revs, maln.fpsm, maln.rpsm, n,
                )
            cc.counts = counts
            cc.cov = cov
            cc.scores = scores
            profiling.count("consensus.device_calls")
            return cc
        except Exception:
            profiling.count("consensus.device_fallbacks")

    # chunk the flattened observation stream: the peak temp footprint stays
    # ~CHUNK elements, so its pages fault once and are reused by every later
    # block/call.  Accumulation order within a column is unchanged and the
    # float64 score sums are integer-exact, so chunking is bit-neutral.
    CHUNK = 2 * 1024 * 1024
    csum = np.cumsum(spans, dtype=np.int64)
    total = int(csum[-1])
    cuts = np.searchsorted(csum, np.arange(CHUNK, total, CHUNK)) + 1
    edges = np.unique(np.concatenate(([0], cuts, [len(recs)])))
    for lo, hi in zip(edges[:-1], edges[1:]):
        sp = spans[lo:hi]
        tot = int(sp.sum())
        if tot == 0:
            continue
        ridx = np.repeat(np.arange(lo, hi, dtype=np.int32), sp)
        off = np.concatenate(([0], np.cumsum(sp, dtype=np.int32)[:-1]))
        within = np.arange(tot, dtype=np.int32) - np.repeat(off, sp)
        cols = starts[ridx] + within
        ok = (cols >= 0) & (cols < n)
        ridx, within, cols = ridx[ok], within[ok], cols[ok]
        cc.add_bases(
            cols,
            seq_arena[seq_off[ridx] + within],
            smp_arena[smp_off[ridx] + within].astype(np.int32) - ord("A"),
            revs[ridx],
            maln.fpsm,
            maln.rpsm,
        )
    return cc


def _record_spans(maln: MapAlignment):
    """Every record's start, end, PSSM-code length and strand as arrays, in
    maln order: one pass over the records instead of a python scan of them
    per insertion column (the reference rescans all reads per column,
    src/map_align.c:463-467; at 100k reads x hundreds of insertion columns
    the python scan was minutes)."""
    seqs = maln.aln_seqs
    # cache keyed on (pool identity, live count): every record-set change in
    # the assembly flow goes through set_aln_seqs (fresh pool list), so the
    # arrays stay valid for the whole consensus pass and for the ma writers'
    # column-by-column calls; the pool reference in the cache also pins the
    # list against id reuse
    cache = getattr(maln, "_spans_cache", None)
    if (
        cache is None
        or cache[0] is not maln.pool
        or cache[1] != maln.num_aln_seqs
    ):
        n = len(seqs)
        spans = (
            np.fromiter((a.start for a in seqs), np.int64, n),
            np.fromiter((a.end for a in seqs), np.int64, n),
            np.fromiter((len(a.smp) for a in seqs), np.int64, n),
            np.fromiter((a.revcom for a in seqs), bool, n),
        )
        cache = (maln.pool, maln.num_aln_seqs, spans)
        maln._spans_cache = cache
    return cache[2]


def insertion_consensus(maln: MapAlignment, positions: np.ndarray, reduce_cc=None):
    """Consensus of the insertion columns immediately upstream of each of
    ``positions`` (sorted, distinct) in one batch: find_ins_cons
    (src/map_align.c:444-510) for every position at once.  Position j's
    ``gaps[positions[j]]`` columns are laid end to end in one ColumnCounts,
    so one ``add_bases``, one ``reduce_cc`` and one ``find_consensus_cols``
    serve them all; a column's counts and decision are its own, so the
    batch is exact.  A record counts at a position when ``start < pos <=
    end`` and its PSSM codes reach ``pos``, dropped reads included, as in
    the reference: each such pair fills its columns with gaps, then with the
    record's insertion there, cut to the width.

    Returns (chars uint8 [n], ColumnCounts, frac [n], first [len + 1]),
    where position j's columns are ``first[j]:first[j + 1]``."""
    positions = np.asarray(positions, dtype=np.int64)
    widths = maln.ref.gaps[positions].astype(np.int64)
    first = np.concatenate(([0], np.cumsum(widths)))
    cc = ColumnCounts(int(first[-1]))
    seqs = maln.aln_seqs
    starts, ends, smp_lens, revs = _record_spans(maln)
    # a record's positions are those in (start, end] below start +
    # len(smp): one run [lo, hi) of ``positions``, one pair each
    lo = np.searchsorted(positions, starts, side="right")
    hi = np.minimum(
        np.searchsorted(positions, ends, side="right"),
        np.searchsorted(positions, starts + smp_lens, side="left"),
    )
    per = np.maximum(hi - lo, 0)
    pair_first = np.cumsum(per) - per
    rec = np.repeat(np.arange(len(seqs)), per)
    j = lo[rec] + np.arange(len(rec)) - pair_first[rec]
    w = widths[j]
    char_first = np.cumsum(w) - w
    n_chars = int(w.sum())
    if n_chars:
        chars = bytearray(b"-" * n_chars)
        index = {p: k for k, p in enumerate(positions.tolist())}
        has = np.flatnonzero(per)
        for r, r_lo, r_hi, r_first in zip(
            has.tolist(), lo[has].tolist(), hi[has].tolist(), pair_first[has].tolist()
        ):
            a = seqs[r]
            for k, ins in a.ins.items():
                jj = index.get(a.start + k, -1)
                if r_lo <= jj < r_hi:
                    p = r_first + jj - r_lo
                    c0 = int(char_first[p])
                    part = ins[: int(w[p])].encode("latin-1")
                    chars[c0 : c0 + len(part)] = part
        # each pair's PSSM depth, from the records' codes laid end to end
        smp_arena = np.frombuffer(
            "".join(seqs[r].smp for r in has.tolist()).encode("latin-1"), np.uint8
        )
        smp_off = np.zeros(len(seqs), dtype=np.int64)
        smp_off[has] = np.cumsum(smp_lens[has]) - smp_lens[has]
        depths = smp_arena[smp_off[rec] + positions[j] - starts[rec]].astype(np.int64)
        cc.add_bases(
            np.repeat(first[j] - char_first, w) + np.arange(n_chars),
            np.frombuffer(chars, dtype=np.uint8),
            np.repeat(depths - ord("A"), w),
            np.repeat(revs[rec], w),
            maln.fpsm,
            maln.rpsm,
        )
    if reduce_cc is not None:
        cc = reduce_cc(cc)
    chars, frac = find_consensus_cols(cc, maln.cons_code)
    return chars, cc, frac, first


def find_ins_cons(maln: MapAlignment, pos: int, reduce_cc=None):
    """Consensus of the insertion columns immediately upstream of ``pos``
    (find_ins_cons, src/map_align.c:444-510).  Includes dropped reads, as the
    reference does.  Returns (chars uint8 [L], ColumnCounts, frac [L])."""
    chars, cc, frac, _ = insertion_consensus(maln, np.array([pos]), reduce_cc)
    return chars, cc, frac


def consensus_assembly_string(
    maln: MapAlignment, reduce_cc=None, device_hook=None
) -> str:
    """Next-iteration reference from the culled maln
    (consensus_assembly_string, src/mia.c:508-603): gap/space calls are
    dropped; dropped reads are excluded from main columns but not from
    insertion columns.

    ``reduce_cc`` (multi-host): called on every ColumnCounts accumulator
    before the consensus decision — the production all-reduce of the
    reference's BaseCounts (src/map_align.c:229-263); counts are integer so
    the merged decision is exact on every host.  Every host holds the same
    ``gaps``, so the insertion columns' one accumulator has the same layout
    on every host."""
    from ..utils import profiling

    with profiling.phase("consensus.main_counts"):
        cc = main_column_counts(maln, exclude_dropped=True, device_hook=device_hook)
    if reduce_cc is not None:
        cc = reduce_cc(cc)
    cons_chars, _ = find_consensus_cols(cc, maln.cons_code)
    positions = np.flatnonzero(maln.ref.gaps[: maln.ref.seq_len] > 0)
    positions = positions[positions > 0]
    if len(positions):
        with profiling.phase("consensus.ins_cols"):
            ins_chars, _, _, first = insertion_consensus(maln, positions, reduce_cc)
            # each position's insertion calls go just before its own column
            cons_chars = np.insert(
                cons_chars, np.repeat(positions, np.diff(first)), ins_chars
            )
    keep = (cons_chars != ord("-")) & (cons_chars != ord(" "))
    return cons_chars[keep].tobytes().decode("latin-1")


def sort_aln_frags(maln: MapAlignment) -> None:
    """Stable sort by (start, end) (alnSeqCmp, src/map_align.c:393-414)."""
    seqs = maln.aln_seqs
    seqs.sort(key=lambda a: (a.start, a.end))
    maln.set_aln_seqs(seqs)
