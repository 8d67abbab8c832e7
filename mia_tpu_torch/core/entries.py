"""Scoring entries: the shape constants of the entry kernels and the numpy
helpers that build, pack and check entries on the host.

Everything the device sees is an **entry**: a (reference-strand select,
window start, band intervals, read codes, PSSM select) tuple.  Pass 1 ships
each read as two entries (fw + rc strand); iteration realignment ships each
strand-known read as one entry against the new consensus with its strand's
PSSM.  The constants here are the compile-time bounds of
``csrc/dp_entries.cu`` (``torchcfg.check_constants`` holds the built library
against them); the helpers are the host half of the device engine
(:mod:`mia_tpu_torch.core.torch_engine`): entry arrays for a pass-1 read
batch, packed reads, the gap-free traceback shortcut and the windowed exact
DP.  The JAX package keeps the same names in ``mia_tpu/core/jax_engine.py``.

Window verification: the host recomputes the winning strand's DP restricted
to [aec - margin, aec] (margin from the score bound: a gated alignment of
score >= s spans at most len2 + (len2*max_sub - s)/GEP extra columns) and
checks that (best, aec) and the alignment start reproduce exactly; any
disagreement falls back to the full-width exact computation
(mia_tpu_torch/native/src/hostbatch.cc: mia_p1_finish).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import GEP, HIM, INIT_ALN_SEQ_LEN, PSSM_DEPTH
from ..ops.dp_numpy import Alignment

# route-to-host threshold of the -h kernel's row reach (HPW)
HPW_ROUTE = 32


def hp_routes_to_host(seq: str) -> bool:
    """True when the read's longest homopolymer run is >= HPW_ROUTE: past
    the -h kernel's row reach (the JAX package's ring depth, kept as a
    guard), so the read stays on the exact host path (shared by pass 1 and
    the realigner)."""
    if len(seq) < HPW_ROUTE:
        return False
    b = np.frombuffer(seq.encode("latin-1"), np.uint8)
    brk = np.flatnonzero(np.diff(b) != 0)
    runs = np.diff(np.concatenate(([-1], brk, [len(b) - 1])))
    return int(runs.max()) >= HPW_ROUTE


def longest_runs(arena: bytes, off: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """[n] int64: each packed read's longest homopolymer run (0 for an empty
    read), in one pass over the arena; ``longest_runs(...) >= HPW_ROUTE`` is
    :func:`hp_routes_to_host` of every read at once.  ``off`` holds at least
    n read offsets (``BatchHost.pack_reads``'s n + 1 will do)."""
    lens = np.asarray(lens, np.int64)
    n = len(lens)
    out = np.zeros(n, np.int64)
    total = int(lens.sum())
    if total == 0:
        return out
    # the reads end to end, and where each starts in that concatenation
    starts = np.cumsum(lens) - lens
    pos = np.repeat(np.asarray(off[:n], np.int64) - starts, lens) + np.arange(total)
    b = np.frombuffer(arena, np.uint8)[pos]
    new_run = np.ones(total, bool)
    new_run[1:] = b[1:] != b[:-1]
    live = lens > 0
    new_run[starts[live]] = True
    run_at = np.flatnonzero(new_run)
    run_len = np.diff(np.append(run_at, total))
    out[live] = np.maximum.reduceat(run_len, np.searchsorted(run_at, starts[live]))
    return out


SCORE_BATCH = 8192           # reads per pass-1 batch (2 entries each)


def default_batch() -> int:
    """Reads per batch; MIA_SCORE_BATCH overrides (smaller batches keep the
    CPU tests fast)."""
    import os

    return int(os.environ.get("MIA_SCORE_BATCH", SCORE_BATCH))


MAX_INTERVALS = 16
# per-read reference window for the banded scorer; a read whose band spans
# more than WIN_W columns on either strand is WIDE: scored full width by the
# general-width scorers (wide_rows)
WIN_W = 384
L_MAX = INIT_ALN_SEQ_LEN     # 256: the reference's hard read-length cap
REF_BUCKET = 2048            # reference width pads to a multiple of this


@dataclass
class StrandScore:
    best: int
    aec: int


def build_pass1_entries(s2c, lens, fw_ws, rc_ws, fw_ivg, rc_ivg, flags):
    """(ref_sel, starts, ivl, s2c2, ln2, smidx) entry arrays for one pass-1
    read batch (each read = fw + rc entries).  flags: FLAG_SKIP/HOST_ONLY/WIDE reads get empty
    intervals (their scores are garbage the caller ignores)."""
    from .hostbatch import FLAG_HOST_ONLY, FLAG_SKIP, FLAG_WIDE

    n = len(lens)
    inactive = (flags & (FLAG_SKIP | FLAG_HOST_ONLY | FLAG_WIDE)) != 0

    def local_iv(ivg, ws):
        used = (ivg[:, :, 1] > 0) & ~inactive[:n, None]
        return np.where(used[:, :, None], ivg - ws[:n, None, None], 0).astype(
            np.int32
        )

    ref_sel = np.repeat(np.array([0, 1], np.int8), n)
    starts = np.concatenate([fw_ws, rc_ws]).astype(np.int32)
    ivl = np.concatenate([local_iv(fw_ivg, fw_ws), local_iv(rc_ivg, rc_ws)])
    s2c2 = np.concatenate([s2c, s2c]).astype(np.int8)
    ln2 = np.concatenate([lens, lens]).astype(np.int32)
    smidx = np.zeros(2 * n, np.int8)
    return ref_sel, starts, ivl, s2c2, ln2, smidx


def split_pass1_results(best, aec, fw_ws, rc_ws):
    """(fb, fa, rb, ra) with aec in GLOBAL reference coordinates."""
    n = len(best) // 2
    fb = best[:n]
    fa = aec[:n] + fw_ws[:n]
    rb = best[n:]
    ra = aec[n:] + rc_ws[:n]
    return fb, fa, rb, ra


# the score of a strand with no band intervals: INT32_MIN / 2, as the
# native solve's fill_strand leaves it (mia_tpu_torch/native/src/hostbatch.cc)
NO_BAND_SCORE = HIM

# the widest strand window the -h full-width scorer takes (its register
# form's 512 threads x 34 columns, csrc/dp_last_row.cu, whose
# mia_dp_last_row_constants reports it to the loader): an -h WIDE read with
# a wider window on either strand stays with the native solve, a routing
# decided here before dispatch (the human-mt strands, 16,619 columns and the
# wrap, never reach it)
HP_WIDE_COLS = 512 * 34


# the band columns one warp of the band forms scores, with and without -h
# (csrc/dp_band.cu: 12 columns a lane, as csrc/dp_entries.cu's window;
# mia_dp_band_constants and mia_dp_band_hp_constants report it to the
# loader)
BAND_COLS = 32 * 12
# the warps a band row may take (a power of two): a row whose band
# (band_columns) takes more than BAND_COLS columns takes the fewest warps G
# with BAND_COLS * G at least its band, up to BAND_ROW_COLS; a wider band
# goes to the strand form (or, past STRAND_COLS, the full form)
BAND_WARPS = (1, 2, 4, 8)
BAND_ROW_COLS = BAND_COLS * BAND_WARPS[-1]
# the widest band the strand forms score, with and without -h
# (csrc/dp_strand.cu: a cluster of 16 CTAs a row, 2,048 threads of 9
# columns; mia_dp_strand_constants and mia_dp_strand_hp_constants report
# it): at least a whole human-mt strand window and the -h full form's widest
# row (HP_WIDE_COLS), so every -h row past BAND_ROW_COLS fits it; a wider
# band keeps the full form
STRAND_COLS = 2048 * 9


def band_warps(cols) -> np.ndarray:
    """[R] int64: the warps of the band form a row with ``cols`` band
    columns (:func:`band_columns`) takes, 1, 2, 4 or 8; 0 past
    :data:`BAND_ROW_COLS` (not a band row)."""
    cols = np.asarray(cols, np.int64)
    g = np.zeros(len(cols), np.int64)
    for w in reversed(BAND_WARPS):
        g = np.where(cols <= BAND_COLS * w, w, g)
    return g


def band_columns(ivl) -> tuple[np.ndarray, np.ndarray]:
    """(open [R] int64, cols [R] int64) of rows with window-local intervals
    ``ivl`` [R, K, 2]: ``open`` the columns of the union of the intervals
    (touching or overlapping ones count once; an interval with lo >= hi is
    empty), ``cols`` the columns the band forms score, the union
    with the two columns before each of its runs (at least 0), so that
    every open column's two left neighbours are scored too."""
    iv = np.asarray(ivl, np.int64)
    lo, hi = iv[:, :, 0], iv[:, :, 1]
    valid = lo < hi
    order = np.argsort(np.where(valid, lo, np.iinfo(np.int64).max), axis=1, kind="stable")
    lo, hi, valid = (np.take_along_axis(a, order, 1) for a in (lo, hi, valid))
    hi = np.where(valid, hi, 0)
    # the columns each interval adds past every earlier one's end
    before = np.maximum.accumulate(np.concatenate([np.zeros_like(hi[:, :1]), hi[:, :-1]],
                                                  1), 1)

    def union(start):
        return np.where(valid, np.maximum(hi - np.maximum(start, before), 0), 0).sum(1)

    return union(lo), union(np.maximum(lo - 2, 0))


def window_bounds(ivg) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(has [n] bool, win_lo [n] int64, hi [n] int64) of each read's window
    on one strand from its GLOBAL band intervals ``ivg`` [n, K, 2], as the
    native solve's ``fill_strand`` lays it out: from two columns before the
    first interval (at least 0) to the end of the last; ``has`` is False for
    a strand without intervals."""
    ivg = np.asarray(ivg, np.int64)
    used = ivg[:, :, 1] > 0
    first = np.where(used, ivg[:, :, 0], np.iinfo(np.int64).max).min(axis=1)
    has = used.any(axis=1)
    win_lo = np.where(has, np.maximum(first - 2, 0), 0)
    return has, win_lo, np.where(used, ivg[:, :, 1], 0).max(axis=1)


def window_widths(fw_ivg, rc_ivg) -> np.ndarray:
    """[n] int64: the wider of each read's two strand windows
    (:func:`window_bounds`; 0 for a strand without intervals)."""
    widths = [np.where(has, hi - lo, 0) for has, lo, hi in map(window_bounds, (fw_ivg, rc_ivg))]
    return np.maximum(*widths)


def wide_scored(flags, lens, widths=None) -> np.ndarray:
    """[n] bool: the WIDE reads the general-width scorers take: not skipped
    or sent to the host, 1..L_MAX bases, and under ``-h`` (``widths``:
    :func:`window_widths`) no strand window wider than :data:`HP_WIDE_COLS`.
    The rest of the WIDE reads keep the native solve."""
    from .hostbatch import FLAG_HOST_ONLY, FLAG_SKIP, FLAG_WIDE

    flags = np.asarray(flags)
    lens = np.asarray(lens)
    taken = (((flags & FLAG_WIDE) != 0) & ((flags & (FLAG_SKIP | FLAG_HOST_ONLY)) == 0)
             & (lens >= 1) & (lens <= L_MAX))
    if widths is not None:
        taken &= np.asarray(widths) <= HP_WIDE_COLS
    return taken


def wide_order(cols) -> tuple[np.ndarray, tuple, int]:
    """(order [R] int64, band_classes, n_strand) of wide rows with ``cols``
    band columns (:func:`band_columns`), with and without ``-h``: the band
    form's rows first, by the warps each takes (:func:`band_warps`;
    ``band_classes`` rows of each of :data:`BAND_WARPS`), then the strand
    form's (``n_strand``, at most :data:`STRAND_COLS`), then the full
    form's, each part in the rows' order."""
    cols = np.asarray(cols, np.int64)
    g = band_warps(cols)
    rank = np.searchsorted(np.array(BAND_WARPS), g)
    rank = np.where(g > 0, rank, len(BAND_WARPS) + (cols > STRAND_COLS))
    counts = np.bincount(rank, minlength=len(BAND_WARPS) + 2)
    return (np.argsort(rank, kind="stable"), tuple(int(c) for c in counts[:len(BAND_WARPS)]),
            int(counts[len(BAND_WARPS)]))


@dataclass
class WideRows:
    """A batch's WIDE reads as rows of the general-width scorer
    (``dp_cuda.dp_last_row_strand``, under ``-h`` ``dp_cuda.dp_last_row_hp``): one
    row per (read, strand with intervals), each over its own window of the
    strand, exactly the window the native solve fills (``fill_strand``,
    hostbatch.cc: it starts two columns before the first interval and ends
    with the last)."""

    sel: np.ndarray     # [m] int64 the reads taken (wide_scored), batch index
    read: np.ndarray    # [R] int64 each row's read, batch index
    strand: np.ndarray  # [R] int8 0 forward, 1 reverse complement
    win_lo: np.ndarray  # [R] int32 global column of the row's column 0
    ivl: np.ndarray     # [R, K, 2] int32 window-local [lo, hi), (0, 0) unused
    s2c: np.ndarray     # [R, L] int32 read codes (pad 4), or under -h uint8
                        # read chars (pad 0); L the longest read
    lengths: np.ndarray  # [R] int32 read lengths
    width: int          # W: the widest row's columns
    # the leading rows the band form takes (band_columns at most
    # BAND_ROW_COLS), the rows of each of its classes (BAND_WARPS) in
    # that order, then the strand form's rows (band columns at most
    # STRAND_COLS), and the widest window of the rest, the full form's
    # (under -h none: a taken read's window is at most HP_WIDE_COLS)
    n_band: int = 0
    full_width: int = 0
    band_classes: tuple = (0, 0, 0, 0)
    n_strand: int = 0

    @property
    def n(self) -> int:
        return len(self.read)


def wide_rows(flags, lens, s2c, fw_ivg, rc_ivg, hp: bool = False) -> WideRows | None:
    """The rows of a pass-1 batch's :func:`wide_scored` reads (None when it
    has none) from ``BatchHost.prepare``'s read codes, or under ``-h`` the
    read chars of ``pack_chars``, and GLOBAL band intervals: a strand's
    window is :func:`window_bounds`'; a strand without intervals gets no
    row (its score is :data:`NO_BAND_SCORE`).  The rows whose band takes at
    most :data:`BAND_ROW_COLS` columns (:func:`band_columns`) come first,
    as the band form's ``n_band``, ordered by the warps each takes
    (:func:`band_warps`, ``band_classes`` rows of each); the rows whose
    band takes at most :data:`STRAND_COLS` follow, the strand form's
    ``n_strand``; the rest keep the full form at ``full_width``, the widest
    of their own windows.  Each part keeps the rows' (strand, read) order.
    Under ``-h`` a read with a window wider than :data:`HP_WIDE_COLS` is not
    taken, so every taken row fits the band or the strand form."""
    sel = np.flatnonzero(wide_scored(flags, lens,
                                     window_widths(fw_ivg, rc_ivg) if hp else None))
    if not len(sel):
        return None
    ivg = np.concatenate([fw_ivg[sel], rc_ivg[sel]]).astype(np.int64)
    read = np.concatenate([sel, sel])
    strand = np.repeat(np.array([0, 1], np.int8), len(sel))
    has, win_lo, hi = window_bounds(ivg)
    ivg, read, strand, win_lo, hi = ivg[has], read[has], strand[has], win_lo[has], hi[has]
    used = ivg[:, :, 1] > 0
    ivl = np.where(used[:, :, None], ivg - win_lo[:, None, None], 0)
    order, band_classes, n_strand = wide_order(band_columns(ivl)[1])
    read, strand, win_lo, hi, ivl = (a[order] for a in (read, strand, win_lo, hi, ivl))
    n_band = sum(band_classes)
    full_width = int((hi - win_lo)[n_band + n_strand:].max(initial=0))
    lengths = np.asarray(lens, np.int32)[read]
    L = int(lengths.max())
    return WideRows(sel, read, strand, win_lo.astype(np.int32), ivl.astype(np.int32),
                    np.ascontiguousarray(np.asarray(s2c)[read, :L],
                                         np.uint8 if hp else np.int32), lengths,
                    int((hi - win_lo).max()), n_band, full_width, band_classes, n_strand)


def wide_inputs(rows: WideRows, refs: np.ndarray):
    """The general-width scorer's dense inputs for ``rows``, as numpy: (s1c
    [R, W] int32 each row's window of its strand, mask [R, W] bool its
    intervals, s2c [R, L] int32, lengths [R] int32, depths [R, L] int32 the
    PSSM depth per row, src/pssm.c:36-46).  ``refs`` is the scorer's [2,
    WTOT] padded strand codes; a window's columns past them read code 4
    (they are masked).  The device builds the same arrays itself
    (``dp_torch.wide_device_inputs``)."""
    W = rows.width
    cols = np.arange(W, dtype=np.int64)[None, :]
    gcol = rows.win_lo.astype(np.int64)[:, None] + cols
    WTOT = refs.shape[1]
    s1c = np.where(gcol < WTOT, refs[rows.strand.astype(np.int64)[:, None],
                                     np.minimum(gcol, WTOT - 1)], 4).astype(np.int32)
    iv = rows.ivl.astype(np.int64)
    mask = ((cols[:, None, :] >= iv[:, :, 0:1]) & (cols[:, None, :] < iv[:, :, 1:2])).any(1)
    L = rows.s2c.shape[1]
    r = np.arange(L)[None, :]
    from_back = rows.lengths.astype(np.int64)[:, None] - (r + 1)
    depths = np.where(r < PSSM_DEPTH, r,
                      np.where(from_back < PSSM_DEPTH, 2 * PSSM_DEPTH - from_back, PSSM_DEPTH))
    return (s1c, mask, rows.s2c, rows.lengths,
            np.clip(depths, 0, 2 * PSSM_DEPTH).astype(np.int32))


def merge_wide(fb, fa, rb, ra, rows: WideRows, best, aec) -> None:
    """Write the wide rows' (best, window-local aec) into a batch's per-read
    (fb, fa, rb, ra) in place, aec made GLOBAL; a taken read's strand
    without a row gets (:data:`NO_BAND_SCORE`, 0)."""
    for b, a in ((fb, fa), (rb, ra)):
        b[rows.sel] = NO_BAND_SCORE
        a[rows.sel] = 0
    aec = np.asarray(aec, np.int64)
    if (aec < 0).any():
        # a band form's mark of a row whose band is wider than it takes
        raise RuntimeError(f"wide rows {np.flatnonzero(aec < 0)[:5].tolist()}: "
                           "band too wide for the band form")
    aec = aec + rows.win_lo
    fw = rows.strand == 0
    fb[rows.read[fw]] = best[fw]
    fa[rows.read[fw]] = aec[fw]
    rb[rows.read[~fw]] = best[~fw]
    ra[rows.read[~fw]] = aec[~fw]


def mask_intervals(mask: np.ndarray) -> np.ndarray | None:
    """[K,2] (lo, hi-exclusive) intervals of the open columns, or None when
    the mask needs more than MAX_INTERVALS (caller falls back to host)."""
    m = mask.astype(bool)
    d = np.diff(m.astype(np.int8))
    starts = list(np.flatnonzero(d == 1) + 1)
    ends = list(np.flatnonzero(d == -1) + 1)
    if m[0]:
        starts.insert(0, 0)
    if m[-1]:
        ends.append(len(m))
    if len(starts) > MAX_INTERVALS:
        return None
    out = np.zeros((MAX_INTERVALS, 2), np.int32)
    for k, (s, e) in enumerate(zip(starts, ends)):
        out[k] = (s, e)
    return out


def pack_s2c(arena: bytes, off: np.ndarray, lens: np.ndarray, L: int = L_MAX) -> np.ndarray:
    """[n, L] int8 read codes from a packed read arena (one vectorised
    gather; pad code 4)."""
    from ..utils.encoding import BASE2INX

    buf = np.frombuffer(arena, np.uint8)
    cols = np.arange(L, dtype=np.int64)[None, :]
    idx = np.minimum(off[:, None] + cols, max(len(buf) - 1, 0))
    valid = cols < lens[:, None]
    return np.where(valid, BASE2INX[buf[idx]], 4).astype(np.int8)


def diag_gapfree(
    arena: bytes,
    off: np.ndarray,      # [n] read arena offsets (winners)
    lens: np.ndarray,     # [n] read lengths
    bests: np.ndarray,    # [n] device best scores
    aecs: np.ndarray,     # [n] GLOBAL end columns
    ivg: np.ndarray,      # [n, K, 2] GLOBAL band intervals (0,0 = unused)
    ref_fw: np.ndarray,   # [len1] forward-strand reference codes
    ref_rc: np.ndarray,   # [len1] rc-strand codes (pass ref_fw again if n/a)
    sel: np.ndarray,      # [n] strand select (1 = rc row)
    submat: np.ndarray,   # [31,5,5], or [2,31,5,5] selected per entry by
                          # ``sm_sel`` (the realign path's fw/rc PSSM choice)
    sm_sel: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Provably gap-free winners: (mask [n] bool, abc [n] int32).

    If the pure-diagonal substitution sum ending at ``aec`` equals the
    device best and the whole diagonal lies inside one open band interval,
    the reference's traceback IS that gap-free diagonal: S along the
    diagonal can never exceed the prefix sums (or the end value would
    exceed the total, contradiction via the diag candidate
    S[r+1][c+1] >= S[r][c]+sub), so every cell's value equals its diagonal
    prefix, every competing candidate is <= the diagonal predecessor, and
    the reference's tie-breaking prefers diag over gaps/hp while restart
    needs STRICT > (src/mia.c:907-965).  Such winners skip the native
    window refill entirely — the dominant case for short aDNA reads, where
    indels are rare."""
    n = len(off)
    if n == 0:
        return np.zeros(0, bool), np.zeros(0, np.int32)
    lens = np.asarray(lens, np.int64)
    bests = np.asarray(bests)
    abcs = (aecs - lens + 1).astype(np.int64)
    # one interval must cover the whole diagonal's columns
    used = ivg[:, :, 1] > 0
    cover = (
        used
        & (ivg[:, :, 0] <= abcs[:, None])
        & (aecs[:, None] < ivg[:, :, 1])
    ).any(axis=1) & (abcs >= 0)
    # an empty read's diagonal sums to 0
    ok = cover & (lens == 0) & (bests == 0)
    # only a covered read can qualify: sum its diagonal over its bases laid
    # end to end (no padding), each term one gather from the flat PSSM
    c = np.flatnonzero(cover & (lens > 0))
    cl = lens[c]
    total = int(cl.sum())
    if total == 0:
        return ok, abcs.astype(np.int32)
    L = int(cl.max())
    sm = np.asarray(submat)
    starts = np.cumsum(cl) - cl
    at = np.arange(total, dtype=np.int64)
    from ..utils.encoding import BASE2INX

    buf = np.frombuffer(arena, np.uint8)
    s2 = BASE2INX[buf[np.repeat(np.asarray(off, np.int64)[c] - starts, cl) + at]]
    len1 = len(ref_fw)
    cidx = np.minimum(np.repeat(abcs[c] - starts, cl) + at, len1 - 1)
    rc_rows = np.asarray(sel)[c] == 1
    refs = np.asarray(ref_fw, np.int8)
    if rc_rows.any():
        cidx += np.repeat(len1 * rc_rows, cl)
        refs = np.concatenate([refs, np.asarray(ref_rc, np.int8)])
    # 25 * find_sm_depth per (read length, row), src/pssm.c:36-46
    rows = np.arange(L)[None, :]
    from_back = np.arange(L + 1)[:, None] - (rows + 1)
    d = np.where(
        rows < PSSM_DEPTH,
        rows,
        np.where(from_back < PSSM_DEPTH, 2 * PSSM_DEPTH - from_back, PSSM_DEPTH),
    )
    d25 = (np.clip(d, 0, 2 * PSSM_DEPTH) * 25).astype(np.int32).reshape(-1)
    idx = d25[np.repeat(cl * L - starts, cl) + at]
    idx += refs[cidx] * 5
    idx += s2
    if sm.ndim == 4:
        idx += np.repeat(np.asarray(sm_sel, np.int32)[c] * (sm.shape[1] * 25), cl)
    diag_sum = np.add.reduceat(sm.reshape(-1)[idx], starts, dtype=np.int64)
    ok[c] = diag_sum == bests[c]
    return ok, abcs.astype(np.int32)


def pack_chars(arena: bytes, off: np.ndarray, lens: np.ndarray, L: int = L_MAX) -> np.ndarray:
    """[n, L] uint8 raw read chars from a packed read arena (pad 0) — the
    hp device program's input form."""
    buf = np.frombuffer(arena, np.uint8)
    cols = np.arange(L, dtype=np.int64)[None, :]
    idx = np.minimum(off[:, None] + cols, max(len(buf) - 1, 0))
    valid = cols < lens[:, None]
    return np.where(valid, buf[idx], 0).astype(np.uint8)


def hp_pengop_table() -> np.ndarray:
    """int(GOP * frac) per homopolymer length slot (exact C double->int
    truncation: int(a+b) == a + int(b) for integer a, positive b — so the
    gap-length term adds back in integer arithmetic on device)."""
    from ..constants import GOP
    from ..ops.dp_numpy import _HP_FRac

    return np.array([int(GOP * f) for f in list(_HP_FRac) + [0.10]], np.int32)


def windowed_exact_dp(a: Alignment, device_best: int, device_aec: int) -> None:
    """Run the exact host DP for ``a`` restricted to a score-bounded window
    ending at the device-reported end column; falls back to the full width
    when the window result disagrees.  On return a.pw holds the winning
    traceback strings (solve_sg)."""
    from ..ops.dp_numpy import solve_sg

    len2 = a.len2
    max_sub = int(np.max(a.submat))
    slack = (
        max(0, (len2 * max_sub - device_best) // GEP)
        if device_best < len2 * max_sub
        else 0
    )
    margin = len2 + slack + 16

    full_mask = a.align_mask[: a.len1].copy()
    lo = max(device_aec - margin, 0)
    if lo > 0 or device_aec < a.len1 - 1:
        a.align_mask[: a.len1] = 0
        a.align_mask[lo : device_aec + 1] = full_mask[lo : device_aec + 1]
        solve_sg(a)
        a.align_mask[: a.len1] = full_mask
        if a.best_score == device_best and a.aec == device_aec:
            if lo == 0 or a.abc > lo + 2:
                return
        # fall back: recompute over the full (kmer-banded) width
    solve_sg(a)
