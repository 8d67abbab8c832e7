"""Per-read alignment driver and the iterative realignment engine.

Ports sg_align (src/map_align.c:1500-1665), trim_frag
(src/map_align.c:1304-1368) and reiterate_assembly (src/mia_main.c:24-280).
The DP itself runs through :mod:`mia_tpu_torch.ops.dp_numpy` (exact), the
native batch engine, or under ``--engine torch`` the port's scorer
(:class:`~mia_tpu_torch.core.torch_engine.Pass1Scorer`); this module owns
the strand choice, coordinate fixups, circular splits and maln/FSDB
bookkeeping.  It is the JAX package's ``mia_tpu/core/driver.py`` with the
device group of ``reiterate_assembly`` on the port's scorer, in process or
through the resident scoring server (:mod:`mia_tpu_torch.serve`): no
work-stealing, and a device or server failure raises.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from operator import attrgetter

import numpy as np

from ..constants import (
    FIRST_ROUND_SCORE_CUTOFF,
    FLAT_MATCH,
    GEP,
    GOP,
    INIT_ALN_SEQ_LEN,
    REALIGN_BUFFER,
    TRIM_SCORE_CUT,
)
from ..ops.dp_numpy import (
    Alignment,
    dyn_prog,
    find_align_begin,
    max_sg_score,
    populate_pwaln_to_begin,
    solve_sg,
    trim_argmax_last_col,
)
from ..utils import profiling
from ..utils.encoding import encode_seq, pop_hpl_and_hps, revcom
from .entries import (
    HPW_ROUTE,
    L_MAX,
    MAX_INTERVALS,
    WIN_W,
    diag_gapfree,
    longest_runs,
    pack_chars,
    pack_s2c,
)
from .fsdb import add_virgin_fs2fsdb
from ..io.native import unavailable as native_unavailable
from .hostbatch import STATUS_OK, BatchHost
from .merge import add_ref_wrap, c2rcc, merge_pwaln_into_maln, revcom_PWAF, split_pwaln
from .types import FSDB, FragSeq, MapAlignment, PWAlnFrag


def init_alignment(size1: int, size2: int, rc: bool, hp_special: bool) -> Alignment:
    """Workspace sized like the reference's init_alignment
    (src/mia.c:988-1030): size1 rows (fragment) x size2 cols (reference)."""
    a = Alignment()
    a.hp = hp_special
    a.rc = rc
    a.align_mask = np.ones(size2, dtype=np.uint8)
    a.s1c = np.zeros(size2, dtype=np.int8)
    a.s2c = np.zeros(size1, dtype=np.int8)
    return a


def set_seq1(a: Alignment, seq: str, length: int | None = None) -> None:
    a.seq1 = seq
    a.len1 = len(seq) if length is None else length
    enc = encode_seq(seq[: a.len1])
    if len(enc) > len(a.s1c):
        a.s1c = np.zeros(len(enc) + 16, dtype=np.int8)
    a.s1c[: a.len1] = enc


def set_seq2(a: Alignment, seq: str, length: int | None = None) -> None:
    a.seq2 = seq
    a.len2 = len(seq) if length is None else length
    enc = encode_seq(seq[: a.len2])
    if len(enc) > len(a.s2c):
        a.s2c = np.zeros(len(enc) + 16, dtype=np.int8)
    a.s2c[: a.len2] = enc


def set_hp_cols(a: Alignment) -> None:
    a.hpcl, a.hpcs = pop_hpl_and_hps(a.seq1[: a.len1])


def set_hp_rows(a: Alignment) -> None:
    a.hprl, a.hprs = pop_hpl_and_hps(a.seq2[: a.len2])


def trim_frag(frag_seq: FragSeq, adapter: str, align: Alignment) -> None:
    """Adapter trimming via DP of adapter (rows) vs read (columns); sets
    trimmed/trim_point (src/map_align.c:1304-1368)."""
    set_seq1(align, frag_seq.seq)
    if align.hp:
        set_hp_cols(align)
    dyn_prog(align)
    max_score = trim_argmax_last_col(align)
    find_align_begin(align)
    if max_score >= TRIM_SCORE_CUT or max_score >= (
        (align.aer - align.abr + 1) * FLAT_MATCH
    ):
        frag_seq.trimmed = True
        frag_seq.trim_point = align.abc - 1
    else:
        frag_seq.trimmed = False


def sg_align(
    maln: MapAlignment,
    fs: FragSeq,
    fsdb: FSDB,
    fw_a: Alignment,
    rc_a: Alignment,
) -> bool:
    """Align one read fw+rc, keep the better strand, merge into the maln and
    insert into the FSDB (src/map_align.c:1500-1665)."""
    rs = maln.ref
    length = fs.trim_point + 1 if fs.trimmed else fs.seq_len
    if length <= 0:
        # adapter trimming consumed the whole read: the reference runs a
        # len2=0 DP here and emits uninitialised-memory garbage
        # (src/mia.c:1514-1543 with trim_point == -1); we define such reads
        # as unalignable and skip them
        return True
    set_seq2(fw_a, fs.seq, length)
    set_seq2(rc_a, fs.seq, length)
    if fw_a.hp:
        set_hp_rows(fw_a)
        set_hp_rows(rc_a)
    fw_a.sg5 = fw_a.sg3 = True
    rc_a.sg5 = rc_a.sg3 = True

    # traceback emit is O(path length) — cheap enough to do for both
    # strands rather than refill the winner
    solve_sg(fw_a)
    solve_sg(rc_a)
    best_a = fw_a if fw_a.best_score > rc_a.best_score else rc_a

    pw = best_a.pw if best_a.pw is not None else populate_pwaln_to_begin(best_a)
    finish_alignment(
        maln, fs, fsdb, best_a.rc, best_a.best_score, best_a.abc, best_a.aec, pw
    )
    return True


def finish_alignment(
    maln: MapAlignment,
    fs: FragSeq,
    fsdb: FSDB,
    rc: bool,
    best_score: int,
    abc: int,
    aec: int,
    pw: tuple[str, str],
) -> None:
    """Merge one aligned read into the maln + FSDB given its winning strand's
    traceback (the bookkeeping half of sg_align, src/map_align.c:1560-1665).
    Shared between the per-read host path and the batched native/device path."""
    rs = maln.ref
    front = PWAlnFrag()
    front.ref_id = rs.id
    front.ref_desc = rs.desc
    front.frag_id = fs.id
    front.frag_desc = fs.desc
    front.ref_seq, front.frag_seq = pw
    front.start = abc
    front.end = aec
    front.trimmed = fs.trimmed
    front.segment = "a"
    front.score = best_score
    fs.score = best_score

    if rc:
        revcom_PWAF(front)
        front.revcom = True
        fs.rc = True
        front.start = c2rcc(aec, rs.seq_len)
        front.end = c2rcc(abc, rs.seq_len)
        fs.as_ = c2rcc(aec, rs.seq_len)
        fs.ae = c2rcc(abc, rs.seq_len)
    else:
        front.revcom = False
        fs.rc = False
        fs.as_ = abc
        fs.ae = aec
    if fs.as_ > fs.ae:
        # wrapped rc alignment: keep ae beyond seq_len for the next round
        # (src/map_align.c:1600-1604)
        fs.ae = rs.seq_len + fs.as_

    if front.end > rs.seq_len:
        front.end = front.end - rs.seq_len

    if fs.score >= FIRST_ROUND_SCORE_CUTOFF or maln.distant_ref:
        if front.start > front.end:
            back = split_pwaln(front, rs.seq_len)
            fs.front_asp = merge_pwaln_into_maln(front, maln)
            fs.back_asp = merge_pwaln_into_maln(back, maln)
            fs.back_fresh = True
        else:
            fs.front_asp = merge_pwaln_into_maln(front, maln)
            fs.back_asp = None
            fs.back_fresh = False
        fs.unique_best = True
        fs.num_inputs = 1
        fs.strand_known = fs.score > FIRST_ROUND_SCORE_CUTOFF
        add_virgin_fs2fsdb(fs, fsdb)


def _fill_slot(maln: MapAlignment, fs: FragSeq, score: int, start: int, end: int,
               revcom_: bool, num_inputs: int, seq: str):
    """``merge_pwaln_into_maln`` of an unsplit alignment with no '-' in its
    reference string: the next slot's fields, ``dropped`` and ``smp`` left
    as they were."""
    asp = maln.next_slot()
    asp.id = fs.id
    asp.desc = fs.desc
    asp.score = score
    asp.start = start
    asp.end = end
    asp.revcom = revcom_
    asp.trimmed = fs.trimmed
    asp.segment = "a"
    asp.num_inputs = num_inputs
    asp.seq = seq
    asp.ins = {}
    return asp


def finish_gapfree(
    maln: MapAlignment,
    fs: FragSeq,
    fsdb: FSDB,
    rc: bool,
    best_score: int,
    abc: int,
    aec: int,
) -> bool:
    """:func:`finish_alignment` of a winner whose traceback is the gap-free
    diagonal abc..aec (``entries.diag_gapfree``), for a caller whose
    reference strand holds no '-': the same slot, fields and FSDB entry,
    without the traceback strings or a PWAlnFrag, and an rc read
    reverse-complemented once.  Returns False, having touched nothing, when
    the span crosses the origin: ``finish_alignment`` splits it."""
    seq_len = maln.ref.seq_len
    if rc:
        start = c2rcc(aec, seq_len)
        end = c2rcc(abc, seq_len)
    else:
        start, end = abc, aec
    # start <= end below, so finish_alignment's wrap rule for fs.ae is moot
    as_, ae = start, end
    if end > seq_len:
        end -= seq_len
    if start > end:
        return False
    fs.score = best_score
    fs.rc = rc
    fs.as_ = as_
    fs.ae = ae
    if best_score < FIRST_ROUND_SCORE_CUTOFF and not maln.distant_ref:
        return True
    length = fs.trim_point + 1 if fs.trimmed else fs.seq_len
    seq = revcom(fs.seq[:length]) if rc else fs.seq[:length]
    fs.front_asp = _fill_slot(maln, fs, best_score, start, end, rc, 0, seq)
    fs.back_asp = None
    fs.back_fresh = False
    fs.unique_best = True
    fs.num_inputs = 1
    fs.strand_known = best_score > FIRST_ROUND_SCORE_CUTOFF
    # add_virgin_fs2fsdb, with the read already reverse-complemented
    if fs.trimmed:
        fs.qual = fs.qual[:length]
        fs.seq_len = length
    if rc and fs.strand_known:
        fs.seq = seq
        fs.qual = fs.qual[: fs.seq_len][::-1]
    elif fs.trimmed:
        fs.seq = fs.seq[:length]
    fs.qss = None
    fsdb.add(fs)
    return True


def merge_realigned(
    maln: MapAlignment, fs: FragSeq, best: int, abc: int, aec: int, pw: tuple[str, str]
) -> None:
    """Merge one realigned read (abc/aec in global reference coords; the
    bookkeeping half of the loop body, src/mia_main.c:236-276)."""
    ref = maln.ref
    front = PWAlnFrag()
    front.ref_seq, front.frag_seq = pw
    front.ref_id = ref.id
    front.ref_desc = ref.desc
    front.frag_id = fs.id
    front.frag_desc = fs.desc
    front.trimmed = fs.trimmed
    front.revcom = fs.rc
    front.num_inputs = fs.num_inputs
    front.segment = "a"
    front.score = best
    front.start = abc
    front.end = aec

    fs.as_ = abc
    fs.ae = aec
    fs.unique_best = True
    fs.score = best

    if front.end > ref.seq_len:
        front.end = front.end - ref.seq_len

    if front.start > front.end:
        back = split_pwaln(front, ref.seq_len)
        fs.front_asp = merge_pwaln_into_maln(front, maln)
        fs.back_asp = merge_pwaln_into_maln(back, maln)
        fs.back_fresh = True
    else:
        fs.back_fresh = False
        fs.front_asp = merge_pwaln_into_maln(front, maln)
        # reference quirk: reiterate does NOT clear back_asp here
        # (src/mia_main.c:273-276, unlike sg_align's else branch), so
        # a read split in pass 1 but not in this iteration keeps a
        # stale back_asp aliasing another slot — and cull will emit
        # that slot's record twice.  Preserved for byte parity.


def merge_realigned_gapfree(
    maln: MapAlignment, fs: FragSeq, best: int, abc: int, aec: int
) -> bool:
    """:func:`merge_realigned` of a realignment whose traceback is the
    gap-free diagonal abc..aec, for a caller whose consensus holds no '-':
    the same slot and fields without the traceback strings or a PWAlnFrag
    (``back_asp`` stays as it was, the reference's quirk).  Returns False,
    having touched nothing, when the span crosses the origin."""
    end = aec - maln.ref.seq_len if aec > maln.ref.seq_len else aec
    if abc > end:
        return False
    fs.as_ = abc
    fs.ae = aec
    fs.unique_best = True
    fs.score = best
    fs.back_fresh = False
    fs.front_asp = _fill_slot(maln, fs, best, abc, end, fs.rc, fs.num_inputs, fs.seq)
    return True


def realign_windows(as_, ae, len2, wrap_seq_len: int):
    """[lo, hi) realignment windows (src/mia_main.c:191-212) of reads with
    spans ``as_``..``ae`` and lengths ``len2``: numpy arrays, or one read's
    ints."""
    lo = np.maximum(np.asarray(as_) - REALIGN_BUFFER, 0)
    hi = np.where(np.asarray(ae) + REALIGN_BUFFER + 1 > wrap_seq_len, wrap_seq_len,
                  np.asarray(ae) + REALIGN_BUFFER)
    whole = lo + len2 > hi
    return np.where(whole, 0, lo), np.where(whole, wrap_seq_len, hi)


def reiterate_assembly(
    new_ref_seq: str,
    iter_num: int,
    maln: MapAlignment,
    fsdb: FSDB,
    a: Alignment,
    ancsubmat: np.ndarray,
    rcancsubmat: np.ndarray,
    engine: str = "native",
    placement=None,
) -> None:
    """Re-align every FSDB read against the new consensus
    (src/mia_main.c:24-280).

    Known-strand reads realign in a [as-50, ae+50] window; unknown-strand
    reads under -D re-probe both strands full-length.  Reads normalised to
    reference orientation score with the revcom PSSM so end-damage stays on
    the right molecular end.

    With ``engine == "torch"`` the window DP scoring for every device-sized
    window runs batched on the scorer that ``placement``
    (:class:`~mia_tpu_torch.core.assembler.Placement`) makes for the new
    consensus: on this process's device, sharded over ``--dp-devices``, or
    on the resident server, where it is freed once drained (one entry per
    read, the read's strand picking the fw/rc PSSM), and only the score-verified margin-window
    traceback stays on the native threads; windows wider than the device
    window, and under ``-h`` reads with a homopolymer run of HPW or more, go
    to the native solver (a work partition, counted as
    ``reiterate.native_entries``).  Under ``-h`` the scorer stays on one
    device: the ``-h`` kernel has no sharded form in the JAX package either
    (there a mesh sends ``-h`` realignment to the native engine; here the
    single-device ``-h`` kernel keeps it on the card, with equal bytes)."""
    t_setup = time.time()
    ref = maln.ref
    ref_len = len(new_ref_seq)
    ref.seq = new_ref_seq
    ref.rcseq = None
    if iter_num > 1:
        ref.id = f"ConsAssem.{iter_num}"
        ref.desc = "iteration assembly"
    ref.seq_len = ref_len
    ref.size = ref_len + 1
    if ref.circular:
        add_ref_wrap(ref)
    else:
        ref.wrap_seq_len = ref.seq_len
    ref.gaps = np.zeros(ref.wrap_seq_len + 1, dtype=np.int64)

    if a.hp:
        a.hpcl, a.hpcs = pop_hpl_and_hps(ref.seq[: ref.wrap_seq_len])

    # clear insert arrays of live slots, then reset the logical count; slot
    # objects persist for reuse (src/mia_main.c:81-106)
    for asp in maln.pool[: maln.num_aln_seqs]:
        asp.ins = {}
    maln.num_aln_seqs = 0

    def _reprobe(fs: FragSeq) -> None:
        """Distant-ref + unknown strand: full-length fw+rc re-probe
        (src/mia_main.c:120-174)."""
        a.submat = ancsubmat
        set_seq1(a, ref.seq[: ref.wrap_seq_len])
        set_seq2(a, fs.seq)
        if a.hp:
            set_hp_rows(a)
            set_hp_cols(a)
        solve_sg(a, do_trace=False)
        max_score = a.best_score
        if max_score > FIRST_ROUND_SCORE_CUTOFF:
            fs.strand_known = True
            fs.rc = False
            fs.as_ = a.abc
            fs.ae = a.aec
            fs.score = max_score

        a.submat = rcancsubmat
        tmp_rc = revcom(fs.seq)
        set_seq2(a, tmp_rc, a.len2)
        if a.hp:
            set_hp_rows(a)
            set_hp_cols(a)
        solve_sg(a, do_trace=False)
        max_score = a.best_score
        if max_score > FIRST_ROUND_SCORE_CUTOFF and max_score > fs.score:
            fs.strand_known = True
            fs.rc = True
            fs.as_ = a.abc
            fs.ae = a.aec
            fs.score = max_score
            fs.seq = tmp_rc

    def _python_realign(fs: FragSeq) -> None:
        """Per-read window realignment on the exact host path."""
        a.submat = rcancsubmat if fs.rc else ancsubmat
        set_seq2(a, fs.seq)
        ref_start, ref_end = realign_windows(fs.as_, fs.ae, a.len2, ref.wrap_seq_len)
        ref_start = int(ref_start)
        set_seq1(a, ref.seq[ref_start : int(ref_end)])
        if a.hp:
            set_hp_rows(a)
            set_hp_cols(a)
        solve_sg(a)
        pw = a.pw if a.pw is not None else populate_pwaln_to_begin(a)
        merge_realigned(maln, fs, a.best_score, a.abc + ref_start, a.aec + ref_start, pw)

    # every read's batched result by FSDB position: a gap-free diagonal
    # (best, abc, aec) or a native traceback; the merge below then runs in
    # FSDB order as before, and a read with neither takes the per-read path
    fss = fsdb.fss
    n_fss = len(fss)
    gapfree = np.zeros(n_fss, bool)
    g_best = np.zeros(n_fss, np.int64)
    g_abc = np.zeros(n_fss, np.int64)
    g_aec = np.zeros(n_fss, np.int64)
    traced: dict[int, tuple] = {}
    reprobed = False
    ref_str = ref.seq[: ref.wrap_seq_len]
    bh = BatchHost.create(
        ref_str,
        ref_str,
        ref.wrap_seq_len,
        ancsubmat,
        rcancsubmat,
        -1,
        False,
        0,
        0,
        upper=False,
        hp=a.hp,
    )
    if bh is None and engine == "torch":
        raise native_unavailable()
    if bh is not None:
        # re-probes first: they can set strand_known (and flip fs.seq).
        # Both strands of every unknown read go through the threaded native
        # full-width window solver in chunks (the per-read python probe is
        # quadratic pain at distant-ref scale, src/mia_main.c:120-174)
        if maln.distant_ref and iter_num > 1:
            todo = [fs for fs in fss if not fs.strand_known]
            if todo:
                probe_reads: list[str] = []
                for fs in todo:
                    probe_reads.append(fs.seq)
                    probe_reads.append(revcom(fs.seq))
                cap = bh.wide_cap
                chunk_n = max(1, (8192 * bh.TRACE_CAP) // max(cap, 1))
                results: list[tuple[int, int, int, int]] = []
                for c0 in range(0, len(probe_reads), chunk_n):
                    chunk = probe_reads[c0 : c0 + chunk_n]
                    arena, off, lens = bh.pack_reads(chunk)
                    m = len(chunk)
                    smidx = np.fromiter(
                        ((c0 + j) % 2 for j in range(m)), np.uint8, m
                    )
                    wlo = np.zeros(m, np.int32)
                    whi = np.full(m, ref.wrap_seq_len, np.int32)
                    meta, _, _ = bh.solve_rei(
                        arena, off[:-1], lens, smidx, wlo, whi, cap=cap
                    )
                    for j in range(m):
                        results.append(
                            (int(meta[j, 0]), int(meta[j, 1]), int(meta[j, 2]),
                             int(meta[j, 3]))
                        )
                for t, fs in enumerate(todo):
                    st_f, best_f, abc_f, aec_f = results[2 * t]
                    st_r, best_r, abc_r, aec_r = results[2 * t + 1]
                    if st_f != STATUS_OK or st_r != STATUS_OK:
                        _reprobe(fs)  # arena overflow etc.: exact per-read
                        continue
                    if best_f > FIRST_ROUND_SCORE_CUTOFF:
                        fs.strand_known = True
                        fs.rc = False
                        fs.as_ = abc_f
                        fs.ae = aec_f
                        fs.score = best_f
                    if best_r > FIRST_ROUND_SCORE_CUTOFF and best_r > fs.score:
                        fs.strand_known = True
                        fs.rc = True
                        fs.as_ = abc_r
                        fs.ae = aec_r
                        fs.score = best_r
                        fs.seq = revcom(fs.seq)
            reprobed = True
        scorer = None
        if engine == "torch":
            enc = encode_seq(ref_str)
            # -h: reads realign on the fw strand (smidx picks the PSSM), so
            # both strand slots carry the consensus's chars and runs
            hp_seqs = (ref_str, ref_str) if a.hp else None
            scorer = placement.scorer(enc, enc, ref.wrap_seq_len, ancsubmat, rcancsubmat,
                                      hp_seqs=hp_seqs)
        profiling.add_time("reiterate.setup", time.time() - t_setup)
        t_cls = time.time()
        # the strand-known reads' spans, strands and packed sequences, once;
        # window sizes are known up front: group reads by whether their
        # window fits the device scorer, then by whether their traceback
        # fits the default arena; solve each group batched
        pos = np.flatnonzero(np.fromiter(map(attrgetter("strand_known"), fss), bool, n_fss))
        known = fss if len(pos) == n_fss else [fss[k] for k in pos.tolist()]
        m = len(known)
        arena, off, lens = bh.pack_reads(list(map(attrgetter("seq"), known)))
        off = off[:-1]
        as_ = np.fromiter(map(attrgetter("as_"), known), np.int64, m)
        ae = np.fromiter(map(attrgetter("ae"), known), np.int64, m)
        smidx = np.fromiter(map(attrgetter("rc"), known), np.int8, m)
        lo, hi = realign_windows(as_, ae, lens, ref.wrap_seq_len)
        lo = lo.astype(np.int32)
        hi = hi.astype(np.int32)
        wide = (hi - lo) + lens + 2 > bh.TRACE_CAP
        device = np.zeros(m, bool)
        if scorer is not None:
            device = ~wide & (hi - np.maximum(lo - 2, 0) <= WIN_W) & (lens <= L_MAX)
            if a.hp:
                # reads with a homopolymer run of HPW or more stay on the
                # native solver, as in mia_tpu (entries.hp_routes_to_host)
                device &= longest_runs(arena, off, lens) < HPW_ROUTE
        narrow = ~wide & ~device
        profiling.add_time("reiterate.classify", time.time() - t_cls)
        if scorer is not None:
            profiling.count("reiterate.device_entries", int(device.sum()))
            profiling.count("reiterate.native_entries", m - int(device.sum()))
        # device-sized windows: dispatch ALL chunks asynchronously, then
        # run the native groups (the device scores while the host solves)
        t_disp = time.time()
        dev_handles: list = []
        dev_idx = np.flatnonzero(device)  # empty without a scorer
        for c0 in range(0, len(dev_idx), scorer.E if scorer is not None else 1):
            idx = dev_idx[c0 : c0 + scorer.E]
            k = len(idx)
            ws = np.maximum(lo[idx] - 2, 0)
            ivl = np.zeros((k, MAX_INTERVALS, 2), np.int32)
            ivl[:, 0, 0] = lo[idx] - ws
            ivl[:, 0, 1] = hi[idx] - ws
            s2c = (pack_chars if scorer.hp else pack_s2c)(arena, off[idx], lens[idx])
            handle = scorer.dispatch_entries(
                np.zeros(k, np.int8), ws, ivl, s2c, lens[idx], smidx[idx]
            )
            dev_handles.append((idx, handle, ws))
        profiling.add_time("reiterate.dispatch", time.time() - t_disp)
        t_ns = time.time()
        CHUNK = 8192
        # bound per-chunk output-arena allocation (2 arenas of n*cap
        # bytes): the wide group's cap is the full reference width, so
        # scale its chunk size down to ~TARGET_ARENA bytes per arena
        TARGET_ARENA = CHUNK * bh.TRACE_CAP
        for group, cap in ((narrow, bh.TRACE_CAP), (wide, bh.wide_cap)):
            chunk_n = max(1, min(CHUNK, TARGET_ARENA // max(cap, 1)))
            g_idx = np.flatnonzero(group)
            for c0 in range(0, len(g_idx), chunk_n):
                idx = g_idx[c0 : c0 + chunk_n]
                meta, ref_a, frag_a = bh.solve_rei(
                    arena, off[idx], lens[idx], smidx[idx].astype(np.uint8), lo[idx],
                    hi[idx], cap=cap
                )
                for j, p in enumerate(pos[idx].tolist()):
                    if meta[j, 0] != STATUS_OK:
                        continue  # falls back to the per-read path below
                    n = int(meta[j, 4])
                    traced[p] = (
                        int(meta[j, 1]),
                        int(meta[j, 2]),
                        int(meta[j, 3]),
                        ref_a[j * cap : j * cap + n],
                        frag_a[j * cap : j * cap + n],
                    )
        profiling.add_time("reiterate.native_solve", time.time() - t_ns)
        t_dev = time.time()
        # drain the device chunks: verified margin-window traceback on
        # the native threads (mia_p1_finish), results in global coords.
        # The finish FFI call releases the GIL, so it runs on a worker
        # thread while the main thread waits on the NEXT chunk's device
        # collect — the same overlap pass 1 uses.
        sms2 = np.stack(
            [np.asarray(ancsubmat, np.int64), np.asarray(rcancsubmat, np.int64)]
        )
        enc_codes = encode_seq(ref_str)

        def _finish_chunk(idx, ws, best, aecl):
            aec = (aecl + ws).astype(np.int32)
            k = len(idx)
            ivg = np.zeros((k, 1, 2), np.int32)
            ivg[:, 0, 0] = lo[idx]
            ivg[:, 0, 1] = hi[idx]
            c_off, c_lens, c_sm = off[idx], lens[idx], smidx[idx]
            # provably gap-free realignments skip the native window refill
            # (entries.diag_gapfree; PSSM selected per read by smidx)
            gf_ok, gf_abc = diag_gapfree(
                arena, c_off, c_lens, best.astype(np.int64),
                aec.astype(np.int64), ivg.astype(np.int64),
                enc_codes, enc_codes, np.zeros(k, np.int8), sms2,
                sm_sel=c_sm,
            )
            profiling.count("reiterate.gapfree_shortcut", int(gf_ok.sum()))
            fin = np.flatnonzero(~gf_ok)
            if len(fin) == 0:
                return idx, gf_ok, gf_abc, best, aec, fin, None, None, None, 0
            fcap = min(
                bh.TRACE_CAP,
                int((hi[idx] - lo[idx]).max(initial=1)) + int(c_lens.max(initial=1)) + 64,
            )
            meta, ref_a, frag_a = bh.finish(
                arena,
                c_off[fin],
                c_lens[fin],
                np.zeros(len(fin), np.uint8),
                c_sm[fin].astype(np.uint8),
                best[fin].astype(np.int32),
                aec[fin],
                ivg[fin],
                cap=fcap,
            )
            return idx, gf_ok, gf_abc, best, aec, fin, meta, ref_a, frag_a, fcap

        def _store(fut) -> None:
            idx, gf_ok, gf_abc, best, aec, fin, meta, ref_a, frag_a, cap = fut.result()
            p = pos[idx[gf_ok]]
            gapfree[p] = True
            g_best[p] = best[gf_ok]
            g_abc[p] = gf_abc[gf_ok]
            g_aec[p] = aec[gf_ok]
            for j, p in enumerate(pos[idx[fin]].tolist()):
                n = int(meta[j, 3])
                if n < 0:
                    continue  # native finish failed: per-read path below
                traced[p] = (
                    int(meta[j, 0]),
                    int(meta[j, 1]),
                    int(meta[j, 2]),
                    ref_a[j * cap : j * cap + n],
                    frag_a[j * cap : j * cap + n],
                )

        with ThreadPoolExecutor(1) as fin_pool:
            futs: list = []
            for idx, handle, ws in dev_handles:
                t_col = time.time()
                best, aecl = scorer.collect_entries(handle)
                profiling.add_time("reiterate.drain_collect", time.time() - t_col)
                futs.append(fin_pool.submit(_finish_chunk, idx, ws, best, aecl))
                while len(futs) > 1:
                    _store(futs.pop(0))
            while futs:
                _store(futs.pop(0))
        if scorer is not None:
            scorer.free()
        profiling.add_time("reiterate.device_drain", time.time() - t_dev)
        bh.close()

    t_merge = time.time()
    # gap-free results merge without their traceback strings when the
    # consensus holds no '-' (merge_realigned_gapfree)
    plain_ref = "-" not in ref_str
    gf, gb, ga, ge = gapfree.tolist(), g_best.tolist(), g_abc.tolist(), g_aec.tolist()
    for k, fs in enumerate(fss):
        if maln.distant_ref and not fs.strand_known and iter_num > 1 and not reprobed:
            _reprobe(fs)
        if not fs.strand_known:
            continue
        if gf[k]:
            best, abc, aec = gb[k], ga[k], ge[k]
            if not (plain_ref and merge_realigned_gapfree(maln, fs, best, abc, aec)):
                merge_realigned(maln, fs, best, abc, aec, (ref_str[abc : aec + 1], fs.seq))
            continue
        res = traced.get(k)
        if res is not None:
            best, abc, aec, rb, fb = res
            merge_realigned(maln, fs, best, abc, aec,
                            (rb.decode("latin-1"), fb.decode("latin-1")))
        else:
            _python_realign(fs)
    profiling.add_time("reiterate.merge", time.time() - t_merge)
