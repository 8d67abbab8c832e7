"""Column-wise consensus over a MapAlignment.

Bridges the assembly state to the vectorised consensus ops: one scatter-add
pass builds every main-column accumulator (vs the reference's O(ref_len *
num_reads) rescans, src/mia.c:551-599 / src/map_alignment.c:134-183), while
insertion columns (rare) are handled per gap position exactly like
find_ins_cons (src/map_align.c:444-510).
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


def _covering(maln: MapAlignment, pos: int) -> list:
    """Records with a.start < pos <= a.end, in maln order — one vectorised
    range test instead of a python scan of every record per insertion
    column (the reference rescans all reads per column,
    src/map_align.c:463-467; at 100k reads x hundreds of insertion columns
    the python scan was minutes)."""
    seqs = maln.aln_seqs
    # cache keyed on (pool identity, live count): every record-set change in
    # the assembly flow goes through set_aln_seqs (fresh pool list), so the
    # (start, end) arrays stay valid for the whole consensus pass; the pool
    # reference in the cache also pins the list against id reuse
    cache = getattr(maln, "_cov_cache", None)
    if (
        cache is None
        or cache[0] is not maln.pool
        or cache[1] != maln.num_aln_seqs
    ):
        starts = np.fromiter((a.start for a in seqs), np.int64, len(seqs))
        ends = np.fromiter((a.end for a in seqs), np.int64, len(seqs))
        cache = (maln.pool, maln.num_aln_seqs, starts, ends)
        maln._cov_cache = cache
    _, _, starts, ends = cache
    idx = np.flatnonzero((starts < pos) & (pos <= ends))
    return [seqs[i] for i in idx]


def find_ins_cons(maln: MapAlignment, pos: int, reduce_cc=None):
    """Consensus of the insertion columns immediately upstream of ``pos``
    (find_ins_cons, src/map_align.c:444-510).  Includes dropped reads, as the
    reference does.  Returns (chars uint8 [L], ColumnCounts, frac [L])."""
    L = int(maln.ref.gaps[pos])
    cc = ColumnCounts(L)
    covering = [
        a for a in _covering(maln, pos) if pos - a.start < len(a.smp)
    ]
    m = len(covering)
    if m:
        chars = np.full((m, L), ord("-"), dtype=np.uint8)
        for i, a in enumerate(covering):
            ins = a.ins.get(pos - a.start)
            if ins is not None:
                k = min(len(ins), L)
                chars[i, :k] = np.frombuffer(
                    ins[:k].encode("latin-1"), dtype=np.uint8
                )
        depths = np.fromiter(
            (ord(a.smp[pos - a.start]) - ord("A") for a in covering),
            np.int64,
            m,
        )
        strands = np.fromiter((a.revcom for a in covering), bool, m)
        cols = np.tile(np.arange(L, dtype=np.int64), m)
        cc.add_bases(
            cols,
            chars.reshape(-1),
            np.repeat(depths, L),
            np.repeat(strands, L),
            maln.fpsm,
            maln.rpsm,
        )
    if reduce_cc is not None:
        cc = reduce_cc(cc)
    chars, frac = find_consensus_cols(cc, maln.cons_code)
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
    the merged decision is exact on every host."""
    from ..utils import profiling

    with profiling.phase("consensus.main_counts"):
        cc = main_column_counts(maln, exclude_dropped=True, device_hook=device_hook)
    if reduce_cc is not None:
        cc = reduce_cc(cc)
    cons_chars, _ = find_consensus_cols(cc, maln.cons_code)
    out: list[str] = []
    gaps = maln.ref.gaps
    for pos in range(maln.ref.seq_len):
        if gaps[pos] > 0 and pos > 0:
            ins_chars, _, _ = find_ins_cons(maln, pos, reduce_cc=reduce_cc)
            for ch in ins_chars:
                if ch not in (ord("-"), ord(" ")):
                    out.append(chr(ch))
        c = cons_chars[pos]
        if c not in (ord("-"), ord(" ")):
            out.append(chr(c))
    return "".join(out)


def sort_aln_frags(maln: MapAlignment) -> None:
    """Stable sort by (start, end) (alnSeqCmp, src/map_align.c:393-414)."""
    seqs = maln.aln_seqs
    seqs.sort(key=lambda a: (a.start, a.end))
    maln.set_aln_seqs(seqs)
