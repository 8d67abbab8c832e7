"""Plain PyTorch version of the batched banded DP scorer.

Port of :mod:`mia_tpu.ops.dp_jax` (``batch_last_row``,
``batch_last_row_rowsm``, ``batch_last_row_hp``, ``depths_for``,
``batch_best_and_aec``) and of the XLA
set-up around it in ``mia_tpu.core.jax_engine._entries_core`` /
``_entries_core_hp`` / ``device_depths``.  The row loop is a Python loop over
[B, W] int32 tensors; every value, sentinel and tie-break is the JAX
version's, so the last rows and (best, aec) agree bit for bit.  This is the
reference the CUDA kernels (:mod:`.dp_cuda`) are held against, and the
scorer's path for tensors on the CPU.

Semi-global scoring (dyn_prog, src/mia.c:740-981): row 0 free; column 0
carries the sg5 penalty; gaps are running maxes with GOP+GEP*len cost; a
restart pays the sg5 prefix penalty and wins only when strictly greater;
the last row's maximum (earliest column) is the alignment score.
"""
from __future__ import annotations

import torch

from ..constants import GEP, GOP, HIM, PSSM_DEPTH
from ..core.entries import BAND_ROW_COLS
from ..core.entries import HPW_ROUTE as HPW
from ..core.entries import WIN_W

# below any reachable value, no int32 overflow (same constant as dp_jax)
_LOW = -(2**30) - 2**29


def depths_for(lengths: torch.Tensor, L: int) -> torch.Tensor:
    """PSSM depth slot per (read, row), clipped for padded rows
    (find_sm_depth, src/pssm.c:36-46): [B, L] int64."""
    rows = torch.arange(L, device=lengths.device)[None, :]
    ln = lengths.to(torch.int64)[:, None]
    from_back = ln - (rows + 1)
    d = torch.where(
        rows < PSSM_DEPTH,
        rows,
        torch.where(
            from_back < PSSM_DEPTH, 2 * PSSM_DEPTH - from_back,
            torch.full_like(from_back, PSSM_DEPTH),
        ),
    )
    return d.clamp(0, 2 * PSSM_DEPTH)


def batch_last_row_rowsm(
    s1c: torch.Tensor,      # [B, W] per-read reference codes 0..4
    mask: torch.Tensor,     # [B, W] bool open columns per read
    row_sm: torch.Tensor,   # [B, L, 5] int32 per-row substitution scores
    lengths: torch.Tensor,  # [B] int32 read lengths
    sg5: bool = True,
    cols: torch.Tensor | None = None,  # [B, W] window-local column of each column
) -> torch.Tensor:
    """The DP row at each read's last row (length - 1): [B, W] int32; masked
    columns hold HIM.  Reads whose last row lies outside [1, L) keep row 0,
    as in the JAX scan.  Rows past the longest read are skipped: they never
    reach a snapshot.  Without ``sg5`` a restart and column 0 cost nothing.

    ``cols`` (ascending in each row) scores a subset of each row's window
    columns: column j stands for window column ``cols[b, j]``, whose gap
    costs it takes.  Exact for every open column whose two left neighbours
    are in the subset (:func:`band_layout`)."""
    B, W = mask.shape
    L = row_sm.shape[1]
    dev = mask.device
    i32 = torch.int32
    s1c = s1c.to(torch.int64)
    mask = mask.to(torch.bool)
    lengths = lengths.to(i32)
    if cols is None:
        cols = torch.arange(W, device=dev, dtype=i32)[None, :]
    cols = cols.to(i32)
    him = torch.tensor(HIM, dtype=i32, device=dev)
    low = torch.tensor(_LOW, dtype=i32, device=dev)

    row0 = torch.where(mask, torch.gather(row_sm[:, 0, :].to(i32), 1, s1c), him)
    prev, prev2, rbest, snap = row0, torch.full_like(row0, _LOW), row0, row0
    upd_mask = torch.zeros_like(mask)
    upd_mask[:, :-1] = mask[:, 1:]
    cand_ok = torch.zeros_like(mask)
    cand_ok[:, : W - 2] = mask[:, 2:]
    cand_ok[:, 0] = True
    gep_cols = GEP * cols
    gap_col_cost = GOP + GEP * (cols[:, 2:] - 1)
    last = lengths - 1

    n_rows = min(int(lengths.max()) if B else 0, L)
    for row in range(1, n_rows):
        cell_sub = torch.gather(row_sm[:, row, :].to(i32), 1, s1c)
        sg5_pen = GOP + GEP * (row + 1) if sg5 else 0

        run_max = torch.cummax(torch.where(cand_ok, prev + gep_cols, low), 1).values
        gap_col = torch.full_like(prev, HIM)
        gap_col[:, 2:] = run_max[:, : W - 2] - gap_col_cost

        gap_row = torch.full_like(prev, HIM)
        if row >= 2:
            cand_r = prev2 + GEP * (row - 2)
            rbest = torch.where(upd_mask & (cand_r > rbest), cand_r, rbest)
            gap_row[:, 1:] = rbest[:, :-1] - (GOP + GEP * (row - 1))

        diag = torch.full_like(prev, _LOW)
        diag[:, 1:] = prev[:, :-1]

        base = torch.maximum(torch.maximum(diag, gap_col), gap_row)
        new_row = torch.where(base < -sg5_pen, torch.full_like(base, -sg5_pen),
                              cell_sub + base)
        new_row[:, 0] = cell_sub[:, 0] - sg5_pen
        new_row = torch.where(mask, new_row, him)

        snap = torch.where((last == row)[:, None], new_row, snap)
        prev2, prev = prev, new_row
    return snap


def make_row_sm(submat: torch.Tensor, s2c: torch.Tensor,
                depths: torch.Tensor) -> torch.Tensor:
    """row_sm[b, r, i] = submat[depths[b, r], i, s2c[b, r]]: [B, L, 5] int32
    (dp_pallas.make_row_sm)."""
    sm_t = submat.to(torch.int32).permute(0, 2, 1)  # [31, read base, ref base]
    return sm_t[depths.to(torch.int64), s2c.to(torch.int64)]


def batch_last_row(
    s1c: torch.Tensor,      # [W] shared or [B, W] per-read reference codes 0..4
    mask: torch.Tensor,     # [B, W] bool open columns per read
    s2c: torch.Tensor,      # [B, L] read codes (padded with 4)
    lengths: torch.Tensor,  # [B] int32 read lengths (>= 1)
    depths: torch.Tensor,   # [B, L] PSSM depth per row (clipped)
    submat: torch.Tensor,   # [31, 5, 5] int32
    sg5: bool = True,
    cols: torch.Tensor | None = None,  # [B, W] window-local column of each column
) -> torch.Tensor:
    """``dp_jax.batch_last_row``: :func:`batch_last_row_rowsm` with one PSSM
    for the batch and a reference row that may be shared by it (and, with
    ``cols``, a subset of each row's columns).  The plain version of the
    general-width kernel (:func:`.dp_cuda.dp_last_row`)."""
    B, W = mask.shape
    if s1c.dim() == 1:
        s1c = s1c[None, :].expand(B, W)
    return batch_last_row_rowsm(s1c, mask, make_row_sm(submat, s2c, depths), lengths,
                                sg5=sg5, cols=cols)


def read_runs(s2chr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per (read, row) start row and length of the read's homopolymer run
    (pop_hpl_and_hps over raw chars; the 0 pad byte differs from every base,
    so no run crosses the read's end): ([B, L], [B, L]) int32."""
    B, L = s2chr.shape
    rows = torch.arange(L, device=s2chr.device, dtype=torch.int32)[None, :].expand(B, L)
    edge = torch.ones((B, 1), dtype=torch.bool, device=s2chr.device)
    diff = s2chr[:, 1:] != s2chr[:, :-1]
    changed = torch.cat([edge, diff], dim=1)
    hprs = torch.cummax(torch.where(changed, rows, torch.zeros_like(rows)), 1).values
    ends = torch.cat([diff, edge], dim=1)
    hpre = torch.cummin(torch.where(ends, rows, torch.full_like(rows, L)).flip(1), 1)
    hpre = hpre.values.flip(1)
    return hprs, hpre - hprs + 1


def batch_last_row_hp(
    s1c: torch.Tensor,      # [B, W] window reference codes 0..4
    s1chr: torch.Tensor,    # [B, W] window reference chars
    mask: torch.Tensor,     # [B, W] bool open columns per read
    row_sm: torch.Tensor,   # [B, L, 5] int32 per-row substitution scores
    lengths: torch.Tensor,  # [B] int32 read lengths
    s2chr: torch.Tensor,    # [B, L] read chars (pad 0)
    hpcs_w: torch.Tensor,   # [B, W] int32 global homopolymer start per column
    ws: torch.Tensor,       # [B] int32 window start (global column of column 0)
    pengop: torch.Tensor,   # [11] int32 truncated GOP * fraction table
    cols: torch.Tensor | None = None,  # [B, W] window-local column of each column
) -> torch.Tensor:
    """:func:`batch_last_row_rowsm` plus the ``-h`` homopolymer-discounted
    gap candidates (src/mia.c:883-905): line by line
    ``dp_jax.batch_last_row_hp``, with its ring of the last HPW rows, from
    which ``hp_row`` reads the row before the read's current run started.
    The scan's value semantics collapse the priority chain into one max.

    ``cols`` (ascending in each row) scores a subset of each row's window
    columns: column j stands for window column ``cols[b, j]``, whose gap
    costs and run starts it takes; an hp_col source outside the subset
    gives no candidate.  Exact for every open column whose two left
    neighbours are in the subset (:func:`band_layout`)."""
    B, W = mask.shape
    L = row_sm.shape[1]
    dev = mask.device
    i32 = torch.int32
    s1c = s1c.to(torch.int64)
    s1chr = s1chr.to(i32)
    s2chr = s2chr.to(i32)
    mask = mask.to(torch.bool)
    lengths = lengths.to(i32)
    hpcs_w = hpcs_w.to(i32)
    ws = ws.to(i32)[:, None]
    pengop = pengop.to(i32)
    subset = cols is not None
    if not subset:
        cols = torch.arange(W, device=dev, dtype=i32)[None, :]
    cols = cols.to(i32)
    gcols = ws + cols
    him = torch.tensor(HIM, dtype=i32, device=dev)
    low = torch.tensor(_LOW, dtype=i32, device=dev)

    hprs, hprl = read_runs(s2chr)

    row0 = torch.where(mask, torch.gather(row_sm[:, 0, :].to(i32), 1, s1c), him)
    prev, prev2, rbest, snap = row0, torch.full_like(row0, _LOW), row0, row0
    hist = torch.zeros((HPW, B, W), dtype=i32, device=dev)
    hist[0] = row0
    upd_mask = torch.zeros_like(mask)
    upd_mask[:, :-1] = mask[:, 1:]
    cand_ok = torch.zeros_like(mask)
    cand_ok[:, : W - 2] = mask[:, 2:]
    cand_ok[:, 0] = True
    gep_cols = GEP * cols
    gap_col_cost = GOP + GEP * (cols[:, 2:] - 1)
    last = lengths - 1

    # loop-invariant hp_col gather index: prev[hpcs - 1 - window start]
    hc_idx = (hpcs_w - 1 - ws).clamp(0, W - 1).to(torch.int64)
    hc_ok_static = (hpcs_w != gcols) & (hpcs_w > 0) & (hpcs_w - 1 >= ws)
    if subset:
        # the source's column in the subset, if it is there
        src = (hpcs_w - 1 - ws).to(torch.int64).contiguous()
        at = torch.searchsorted(cols.to(torch.int64).contiguous(), src).clamp(max=W - 1)
        hc_ok_static &= torch.gather(cols, 1, at) == src
        hc_idx = at
    hr_ok_static = (hpcs_w == gcols) & (cols >= 1)
    gap_len = gcols - hpcs_w

    n_rows = min(int(lengths.max()) if B else 0, L)
    for row in range(1, n_rows):
        cell_sub = torch.gather(row_sm[:, row, :].to(i32), 1, s1c)
        sg5_pen = GOP + GEP * (row + 1)

        run_max = torch.cummax(torch.where(cand_ok, prev + gep_cols, low), 1).values
        gap_col = torch.full_like(prev, HIM)
        gap_col[:, 2:] = run_max[:, : W - 2] - gap_col_cost

        gap_row = torch.full_like(prev, HIM)
        if row >= 2:
            cand_r = prev2 + GEP * (row - 2)
            rbest = torch.where(upd_mask & (cand_r > rbest), cand_r, rbest)
            gap_row[:, 1:] = rbest[:, :-1] - (GOP + GEP * (row - 1))

        diag = torch.full_like(prev, _LOW)
        diag[:, 1:] = prev[:, :-1]

        # homopolymer-discounted gaps
        same = s1chr == s2chr[:, row : row + 1]
        hprs_r = hprs[:, row : row + 1]
        pen = GEP * gap_len + pengop[(hprl[:, row] - 1).clamp(0, 10).to(torch.int64)][:, None]
        hp_col = torch.where(same & (hprs_r == row) & hc_ok_static,
                             torch.gather(prev, 1, hc_idx) - pen, him)
        slot = ((hprs_r[:, 0] - 1).clamp(0, L) % HPW).to(torch.int64)
        src = hist[slot, torch.arange(B, device=dev)]
        src1 = torch.full_like(src, HIM)
        src1[:, 1:] = src[:, :-1]
        hr_ok = (same & hr_ok_static & (hprs_r != row) & (hprs_r > 0)
                 & (row - hprs_r < HPW))
        hp_row = torch.where(hr_ok, src1 - pen, him)

        base = torch.maximum(
            torch.maximum(torch.maximum(gap_col, gap_row), torch.maximum(hp_col, hp_row)),
            diag,
        )
        new_row = torch.where(base < -sg5_pen, torch.full_like(base, -sg5_pen),
                              cell_sub + base)
        new_row[:, 0] = cell_sub[:, 0] - sg5_pen
        new_row = torch.where(mask, new_row, him)

        snap = torch.where((last == row)[:, None], new_row, snap)
        hist[row % HPW] = new_row
        prev2, prev = prev, new_row
    return snap


def strand_windows(arr: torch.Tensor, strand: torch.Tensor, win_lo: torch.Tensor,
                   width: int, pad: int) -> torch.Tensor:
    """[R, width] windows of a [2, WTOT] strand array (codes, chars or run
    starts): row r is ``arr[strand[r], win_lo[r] : win_lo[r] + width]``,
    columns past WTOT ``pad``.  Each strand is padded with ``width`` columns,
    so that every window is a slice of one flat array."""
    WTOT = arr.shape[1]
    flat = torch.cat([arr, torch.full((2, width), pad, dtype=arr.dtype, device=arr.device)], 1)
    starts = strand.to(torch.int64) * (WTOT + width) + win_lo.to(torch.int64)
    return flat.reshape(-1).unfold(0, width, 1)[starts]


def interval_mask(ivl: torch.Tensor, width: int) -> torch.Tensor:
    """[R, width] bool: the columns inside any of a row's window-local [lo,
    hi) intervals (``ivl`` [R, K, 2], hi <= width; an unused (0, 0) adds
    nothing).  The running sum of +1 at each start and -1 at each end, so
    no [R, K, width] array is made."""
    iv = ivl.to(torch.int64)
    ones = torch.ones(iv.shape[:2], dtype=torch.int32, device=ivl.device)
    edge = torch.zeros((iv.shape[0], width + 1), dtype=torch.int32, device=ivl.device)
    edge.scatter_add_(1, iv[:, :, 0], ones)
    edge.scatter_add_(1, iv[:, :, 1], -ones)
    return torch.cumsum(edge[:, :width], 1, dtype=torch.int32) > 0


def wide_device_inputs(refs: torch.Tensor, width: int, strand: torch.Tensor,
                       win_lo: torch.Tensor, ivl: torch.Tensor):
    """(s1c [R, W] int32, mask [R, W] bool) of wide rows, made on ``refs``'
    device from the rows' strands, window starts and window-local intervals
    (``entries.wide_inputs`` in numpy; :func:`strand_windows` and
    :func:`interval_mask`): the full form's inputs."""
    return (strand_windows(refs, strand, win_lo, width, 4).to(torch.int32),
            interval_mask(ivl, width))


def last_row_hp_plain(
    refs: torch.Tensor,     # [2, WTOT] int8 padded strand codes
    refchr: torch.Tensor,   # [2, WTOT] uint8 strand chars (pad 0)
    hpcs: torch.Tensor,     # [2, WTOT] int32 homopolymer run start per column
    submat: torch.Tensor,   # [31, 5, 5] int32 PSSM
    pengop: torch.Tensor,   # [11] int32 homopolymer gap-open discounts
    b2i: torch.Tensor,      # [256] int8 char -> code 0..4
    strand: torch.Tensor,   # [R] int8 each row's strand
    win_lo: torch.Tensor,   # [R] int32 global column of the row's column 0
    ivl: torch.Tensor,      # [R, K, 2] int32 window-local [lo, hi) intervals
    s2chr: torch.Tensor,    # [R, L] uint8 read chars (pad 0)
    lengths: torch.Tensor,  # [R] int32 read lengths
    width: int,             # W: every row's window
) -> torch.Tensor:
    """(best, first column of the best) of each row's last ``-h`` DP row over
    its W-column window of its strand, as [2, R] int32, the column
    window-local: :func:`batch_last_row_hp` (``dp_jax.batch_last_row_hp``)
    and :func:`batch_best_and_aec` on the full-width inputs, which are made
    here from the scorer's strand state as ``jax_engine._entries_core_hp``
    makes a window's.  The plain version of the full-width ``-h`` kernel
    (:func:`.dp_cuda.dp_last_row_hp`)."""
    s1c = strand_windows(refs, strand, win_lo, width, 4)
    s1chr = strand_windows(refchr, strand, win_lo, width, 0)
    hpcs_w = strand_windows(hpcs, strand, win_lo, width, 0)
    mask = interval_mask(ivl, width)
    row_sm = make_row_sm(submat, b2i[s2chr.to(torch.int64)],
                         depths_for(lengths, s2chr.shape[1]))
    last = batch_last_row_hp(s1c, s1chr, mask, row_sm, lengths, s2chr, hpcs_w, win_lo,
                             pengop)
    best, aec = batch_best_and_aec(last)
    return torch.stack([best, aec])


def band_layout(ivl: torch.Tensor):
    """The columns the band forms score for rows with window-local
    intervals ``ivl`` [R, K, 2]: (cols [R, C] int64 window-local column of
    each band column, ascending; open [R, C] bool; n [R] int64 each row's
    band columns, ``entries.band_columns``' ``cols``).  A row's band columns
    are the union of its intervals with the two columns before each of its
    runs (at least 0), in order: every open column's two left neighbours
    are its left neighbours here too.  Columns past a row's n are closed
    and continue its last column by one each; a row with more than
    ``entries.BAND_ROW_COLS`` band columns gets none (all its columns
    closed)."""
    iv = ivl.to(torch.int64)
    lo, hi = iv[:, :, 0], iv[:, :, 1]
    valid = lo < hi
    big = torch.iinfo(torch.int64).max
    order = torch.sort(torch.where(valid, lo, big), dim=1, stable=True).indices
    lo, hi, valid = (torch.gather(a, 1, order) for a in (lo, hi, valid))
    hi = torch.where(valid, hi, 0)
    before = torch.cummax(torch.cat([torch.zeros_like(hi[:, :1]), hi[:, :-1]], 1), 1).values
    start = torch.maximum((lo - 2).clamp(min=0), before)
    cnt = torch.where(valid, (hi - start).clamp(min=0), 0)
    n_all = cnt.sum(1)
    cnt = torch.where((n_all <= BAND_ROW_COLS)[:, None], cnt, 0)
    n = cnt.sum(1)
    ends = torch.cumsum(cnt, 1)
    R, C = iv.shape[0], max(int(n.max()) if iv.shape[0] else 0, 1)
    k = torch.arange(C, device=ivl.device)[None, :].expand(R, C).contiguous()
    seg = torch.searchsorted(ends, k, right=True).clamp(max=iv.shape[1] - 1)
    cols = torch.gather(start, 1, seg) + k - torch.gather(ends - cnt, 1, seg)
    cols = torch.where(k < n[:, None], cols, hi.max(1).values[:, None] + k - n[:, None])
    open_ = ((iv[:, None, :, 0] <= cols[:, :, None]) & (cols[:, :, None] < iv[:, None, :, 1])
             ).any(2) & (k < n[:, None])
    return cols, open_, n_all


def last_row_hp_band_plain(
    refs: torch.Tensor,     # [2, WTOT] int8 padded strand codes
    refchr: torch.Tensor,   # [2, WTOT] uint8 strand chars (pad 0)
    hpcs: torch.Tensor,     # [2, WTOT] int32 homopolymer run start per column
    submat: torch.Tensor,   # [31, 5, 5] int32 PSSM
    pengop: torch.Tensor,   # [11] int32 homopolymer gap-open discounts
    b2i: torch.Tensor,      # [256] int8 char -> code 0..4
    strand: torch.Tensor,   # [R] int8 each row's strand
    win_lo: torch.Tensor,   # [R] int32 global column of the row's column 0
    ivl: torch.Tensor,      # [R, K, 2] int32 window-local [lo, hi) intervals
    s2chr: torch.Tensor,    # [R, L] uint8 read chars (pad 0)
    lengths: torch.Tensor,  # [R] int32 read lengths
) -> torch.Tensor:
    """What :func:`last_row_hp_plain` computes, (best, first window column
    of the best) as [2, R] int32, with each row's DP run on its band
    columns only (:func:`band_layout`): the same recurrence, its gap costs
    and run starts from the real window columns, the answer mapped back to
    its real column.  A row without an open column gives (HIM, 0), as the
    full width does; a row whose band takes more than ``entries.BAND_ROW_COLS``
    columns gives (HIM, -1).  The plain version of the ``-h`` band form
    (``csrc/dp_band.cu``'s ``-h`` instantiation, :func:`.dp_cuda.dp_last_row_hp`)."""
    cols, mask, n = band_layout(ivl)
    wide = n > BAND_ROW_COLS
    WTOT = refs.shape[1]
    g = win_lo.to(torch.int64)[:, None] + cols
    inside = g < WTOT
    at = strand.to(torch.int64)[:, None] * WTOT + g.clamp(max=WTOT - 1)

    def win(a, pad):
        return torch.where(inside, a.reshape(-1)[at].to(torch.int32), pad)

    row_sm = make_row_sm(submat, b2i[s2chr.to(torch.int64)],
                         depths_for(lengths, s2chr.shape[1]))
    last = batch_last_row_hp(win(refs, 4), win(refchr, 0), mask, row_sm, lengths, s2chr,
                             win(hpcs, 0), win_lo, pengop, cols=cols)
    best, k = batch_best_and_aec(last)
    aec = torch.where(mask.any(1), torch.gather(cols, 1, k[:, None].to(torch.int64))[:, 0], 0)
    best = torch.where(wide, HIM, best)
    aec = torch.where(wide, -1, aec)
    return torch.stack([best, aec.to(torch.int32)])


def last_row_band_plain(
    refs: torch.Tensor,     # [2, WTOT] int8 padded strand codes
    submat: torch.Tensor,   # [31, 5, 5] int32 PSSM
    strand: torch.Tensor,   # [R] int8 each row's strand
    win_lo: torch.Tensor,   # [R] int32 global column of the row's column 0
    ivl: torch.Tensor,      # [R, K, 2] int32 window-local [lo, hi) intervals
    s2c: torch.Tensor,      # [R, L] int32 read codes (pad 4)
    lengths: torch.Tensor,  # [R] int32 read lengths
) -> torch.Tensor:
    """(best, first window column of the best) of each row's last DP row
    over its whole window of its strand, as [2, R] int32: what
    :func:`batch_last_row` (``dp_jax.batch_last_row``, sg5 on) and
    :func:`batch_best_and_aec` compute on the full-width inputs, with each
    row's DP run on its band columns only (:func:`band_layout`), its gap
    costs from the real window columns and the answer mapped back to its
    real column.  A row without an open column gives (HIM, 0), as the full
    width does; a row whose band takes more than ``entries.BAND_ROW_COLS``
    columns gives (HIM, -1).  The plain version of the band form
    (``csrc/dp_band.cu``'s plain instantiation, :func:`.dp_cuda.dp_last_row_strand`)."""
    cols, mask, n = band_layout(ivl)
    wide = n > BAND_ROW_COLS
    WTOT = refs.shape[1]
    g = win_lo.to(torch.int64)[:, None] + cols
    s1c = torch.where(g < WTOT, refs.reshape(-1)[strand.to(torch.int64)[:, None] * WTOT
                                                 + g.clamp(max=WTOT - 1)].to(torch.int32), 4)
    last = batch_last_row(s1c, mask, s2c, lengths, depths_for(lengths, s2c.shape[1]), submat,
                          cols=cols)
    best, k = batch_best_and_aec(last)
    aec = torch.where(mask.any(1), torch.gather(cols, 1, k[:, None].to(torch.int64))[:, 0], 0)
    best = torch.where(wide, HIM, best)
    aec = torch.where(wide, -1, aec)
    return torch.stack([best, aec.to(torch.int32)])


def last_row_strand_plain(
    refs: torch.Tensor,     # [2, WTOT] int8 padded strand codes
    submat: torch.Tensor,   # [31, 5, 5] int32 PSSM
    strand: torch.Tensor,   # [R] int8 each row's strand
    win_lo: torch.Tensor,   # [R] int32 global column of the row's column 0
    ivl: torch.Tensor,      # [R, K, 2] int32 window-local [lo, hi) intervals
    s2c: torch.Tensor,      # [R, L] int32 read codes (pad 4)
    lengths: torch.Tensor,  # [R] int32 read lengths
) -> torch.Tensor:
    """(best, first window column of the best) of each row's last DP row
    over its window of its strand, as [2, R] int32: :func:`batch_last_row`
    (``dp_jax.batch_last_row``, sg5 on) on the rows' windows
    (:func:`strand_windows`, :func:`interval_mask`) up to their widest
    interval's end, then :func:`batch_best_and_aec`.  The plain version of
    the strand form (``csrc/dp_strand.cu``, :func:`.dp_cuda.dp_last_row_strand`)."""
    width = max(int(ivl[:, :, 1].max()) if ivl.shape[0] else 0, 1)
    s1c, mask = wide_device_inputs(refs, width, strand, win_lo, ivl)
    last = batch_last_row(s1c, mask, s2c, lengths, depths_for(lengths, s2c.shape[1]), submat)
    return torch.stack(batch_best_and_aec(last))


def last_row_hp_strand_plain(
    refs: torch.Tensor,     # [2, WTOT] int8 padded strand codes
    refchr: torch.Tensor,   # [2, WTOT] uint8 strand chars (pad 0)
    hpcs: torch.Tensor,     # [2, WTOT] int32 homopolymer run start per column
    submat: torch.Tensor,   # [31, 5, 5] int32 PSSM
    pengop: torch.Tensor,   # [11] int32 homopolymer gap-open discounts
    b2i: torch.Tensor,      # [256] int8 char -> code 0..4
    strand: torch.Tensor,   # [R] int8 each row's strand
    win_lo: torch.Tensor,   # [R] int32 global column of the row's column 0
    ivl: torch.Tensor,      # [R, K, 2] int32 window-local [lo, hi) intervals
    s2chr: torch.Tensor,    # [R, L] uint8 read chars (pad 0)
    lengths: torch.Tensor,  # [R] int32 read lengths
) -> torch.Tensor:
    """(best, first window column of the best) of each row's last ``-h`` DP
    row over its window of its strand, as [2, R] int32:
    :func:`last_row_hp_plain` (``dp_jax.batch_last_row_hp`` and
    :func:`batch_best_and_aec`) on the rows' windows up to their widest
    interval's end.  The plain version of the ``-h`` strand form
    (``csrc/dp_strand.cu``'s ``-h`` instantiation, :func:`.dp_cuda.dp_last_row_hp`)."""
    width = max(int(ivl[:, :, 1].max()) if ivl.shape[0] else 0, 1)
    return last_row_hp_plain(refs, refchr, hpcs, submat, pengop, b2i, strand, win_lo, ivl,
                             s2chr, lengths, width)


def batch_best_and_aec(last_rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-read (best score, earliest argmax column) of the last DP row."""
    aec = torch.argmax(last_rows, dim=1).to(torch.int32)
    best = torch.gather(last_rows, 1, aec[:, None].to(torch.int64))[:, 0]
    return best, aec


def entries_core_plain(
    refs: torch.Tensor,     # [2, WTOT] int8 padded reference strands
    sms: torch.Tensor,      # [2, 31, 5, 5] int32 PSSMs (fw, rc)
    ref_sel: torch.Tensor,  # [E] int8 strand select
    starts: torch.Tensor,   # [E] int32 window start
    ivl: torch.Tensor,      # [E, K, 2] int32 window-local [lo, hi) intervals
    s2c: torch.Tensor,      # [E, L] int8 read codes (pad 4)
    lengths: torch.Tensor,  # [E] int32 read lengths
    smidx: torch.Tensor,    # [E] int8 PSSM select
) -> torch.Tensor:
    """(best, aec) per entry as [2, E] int32: the plain version of the
    fused scorer (jax_engine._entries_core with the scan scorer).  aec is
    window-local; windows are WIN_W columns wide."""
    idx, maskw = _windows(refs, ref_sel, starts, ivl)
    wins = refs.reshape(-1)[idx]
    row_sm = _row_scores(sms, smidx, lengths, s2c)
    last = batch_last_row_rowsm(wins, maskw, row_sm, lengths)
    best, aec = batch_best_and_aec(last)
    return torch.stack([best, aec])


def entries_core_hp_plain(
    refs: torch.Tensor,     # [2, WTOT] int8 padded reference strand codes
    refchr: torch.Tensor,   # [2, WTOT] uint8 reference strand chars (pad 0)
    hpcs: torch.Tensor,     # [2, WTOT] int32 homopolymer run start per column
    sms: torch.Tensor,      # [2, 31, 5, 5] int32 PSSMs (fw, rc)
    pengop: torch.Tensor,   # [11] int32 homopolymer gap-open discounts
    b2i: torch.Tensor,      # [256] int8 char -> code 0..4
    ref_sel: torch.Tensor,  # [E] int8 strand select
    starts: torch.Tensor,   # [E] int32 window start
    ivl: torch.Tensor,      # [E, K, 2] int32 window-local [lo, hi) intervals
    s2chr: torch.Tensor,    # [E, L] uint8 read chars (pad 0)
    lengths: torch.Tensor,  # [E] int32 read lengths
    smidx: torch.Tensor,    # [E] int8 PSSM select
) -> torch.Tensor:
    """(best, aec) per entry as [2, E] int32 under ``-h``: the plain version
    of ``jax_engine._entries_core_hp``.  Reads come as raw chars; their codes,
    depths and run arrays derive here, as on the TPU."""
    idx, maskw = _windows(refs, ref_sel, starts, ivl)
    flat = idx.reshape(-1)
    wins = refs.reshape(-1)[flat].reshape(idx.shape)
    winchr = refchr.reshape(-1)[flat].reshape(idx.shape)
    winhpcs = hpcs.reshape(-1)[flat].reshape(idx.shape)
    s2c = b2i[s2chr.to(torch.int64)]
    row_sm = _row_scores(sms, smidx, lengths, s2c)
    last = batch_last_row_hp(wins, winchr, maskw, row_sm, lengths, s2chr, winhpcs,
                             starts, pengop)
    best, aec = batch_best_and_aec(last)
    return torch.stack([best, aec])


def _windows(refs: torch.Tensor, ref_sel: torch.Tensor, starts: torch.Tensor,
             ivl: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each entry's flat [E, WIN_W] gather index into a [2, WTOT] strand
    array (clamped, as JAX clamps an out-of-range gather) and its band
    mask [E, WIN_W] from the window-local [lo, hi) intervals."""
    WTOT = refs.shape[1]
    cols = torch.arange(WIN_W, device=refs.device, dtype=torch.int64)[None, :]
    idx = (
        ref_sel.to(torch.int64)[:, None] * WTOT + starts.to(torch.int64)[:, None] + cols
    ).clamp(0, refs.numel() - 1)
    iv = ivl.to(torch.int64)
    maskw = (
        (cols[:, None, :] >= iv[:, :, 0:1]) & (cols[:, None, :] < iv[:, :, 1:2])
    ).any(dim=1)
    return idx, maskw


def _row_scores(sms: torch.Tensor, smidx: torch.Tensor, lengths: torch.Tensor,
                s2c: torch.Tensor) -> torch.Tensor:
    """row_sm[e, r, i] = sms[smidx[e], depth(e, r), i, s2c[e, r]]: [E, L, 5]."""
    depths = depths_for(lengths, s2c.shape[1])
    sm_t = sms.to(torch.int32).permute(0, 1, 3, 2)  # [2, 31, read base, ref base]
    return sm_t[smidx.to(torch.int64)[:, None], depths, s2c.to(torch.int64)]
