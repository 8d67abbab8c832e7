"""Read-database machinery: sorting, dedup, score culling, collapsing.

Ports the FSDB layer (src/fsdb.c, plus collapse/cull logic in
src/mia.c:105-506) onto Python objects + NumPy.  The comparator orders become
stable sort keys; the least-squares score cutoff becomes vector reductions
(whose partial sums are psum-able across hosts, cf. SURVEY §5).
"""
from __future__ import annotations

import math
import sys
from functools import lru_cache

import numpy as np

from ..constants import (
    FIRST_ROUND_SCORE_CUTOFF,
    INIT_ALN_SEQ_LEN,
    MIN_ALIGNABLE_LEN,
    SCORE_CUTOFF_BUFFER,
)
from ..utils.encoding import revcom
from .types import FSDB, AlnSeq, FragSeq, MapAlignment, RefSeq


# --- sort orders (fs_comp src/fsdb.c:13-88, fs_comp_qscore 99-174) ---------

def _fs_key(fs: FragSeq):
    if fs.rc:
        return (0, -fs.ae, fs.as_, -fs.score)
    return (1, fs.as_, -fs.ae, -fs.score)


def _fs_key_qscore(fs: FragSeq):
    if fs.rc:
        return (0, -fs.ae, fs.as_, -fs.qual_sum)
    return (1, fs.as_, -fs.ae, -fs.qual_sum)


def sort_fsdb(fsdb: FSDB) -> None:
    fsdb.fss.sort(key=_fs_key)


def sort_fsdb_qscore(fsdb: FSDB) -> None:
    fsdb.fss.sort(key=_fs_key_qscore)


# --- duplicate marking (src/fsdb.c:440-508) --------------------------------

def set_uniq_in_fsdb(fsdb: FSDB, just_outer_coords: bool, tolerance: int) -> None:
    if not fsdb.fss:
        return
    fs = fsdb.fss[0]
    curr_rc, curr_as, curr_ae = fs.rc, fs.as_, fs.ae
    fs.unique_best = True
    for fs in fsdb.fss[1:]:
        if (
            fs.rc == curr_rc
            and abs(fs.as_ - curr_as) <= tolerance
            and abs(fs.ae - curr_ae) <= tolerance
        ):
            fs.unique_best = False
        else:
            if just_outer_coords:
                fs.unique_best = True
            else:
                # 454 rule: same start (fw) / same end (rc) with an untrimmed
                # shorter read is still redundant (src/fsdb.c:461-501)
                if not fs.rc:
                    fs.unique_best = bool(fs.trimmed) if fs.as_ == curr_as else True
                else:
                    fs.unique_best = bool(fs.trimmed) if fs.ae == curr_ae else True
            curr_rc, curr_as, curr_ae = fs.rc, fs.as_, fs.ae


# --- dynamic score cutoff (src/fsdb.c:269-383) -----------------------------

def _div(a: float, b: float) -> float:
    """C double division semantics: x/0 -> +-inf, 0/0 -> nan."""
    if b == 0:
        if a == 0:
            return float("nan")
        return math.inf if a > 0 else -math.inf
    return a / b


def _native_lib():
    from ..ops.dp_numpy import _load_native

    return _load_native()


def _min_scores_batch(slope: float, intercept: float, lengths: np.ndarray) -> np.ndarray:
    """intercept + slope*length for a length VECTOR, with the reference
    binary's fused multiply-add rounding when the native library is present
    (one FFI call for the whole batch)."""
    lib = _native_lib()
    lens = np.ascontiguousarray(lengths, np.int32)
    if lib is None:
        return intercept + slope * lens.astype(np.float64)
    import ctypes

    out = np.zeros(len(lens), np.float64)
    lib.mia_min_scores(
        ctypes.c_double(slope),
        ctypes.c_double(intercept),
        lens.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(lens)),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def _min_score(slope: float, intercept: float, length: int) -> float:
    """Scalar convenience wrapper over :func:`_min_scores_batch`."""
    return float(_min_scores_batch(slope, intercept, np.array([length], np.int32))[0])


def find_fsdb_score_cut(fsdb: FSDB) -> tuple[float, float]:
    """Least-squares fit of score vs length over unique, above-cutoff reads;
    returns (slope, intercept) with the reference's max-slope-delta haircut.

    Routed through the native library when available: the reference binary's
    gcc -O2 build contracts the fit's multiply-adds into FMAs, and reads
    sitting exactly on the cutoff line need the same rounding to reproduce
    their dropped flags (see mia_tpu_torch/native/src/scorecut.cc)."""
    sel = [
        fs
        for fs in fsdb.fss
        if fs.unique_best and fs.score >= FIRST_ROUND_SCORE_CUTOFF
    ]
    lib = _native_lib()
    if lib is not None:
        import ctypes

        n = len(sel)
        lens = np.array([fs.seq_len for fs in sel], np.int32)
        scores = np.array([fs.score for fs in sel], np.int32)
        selv = np.ones(n, np.uint8)
        s = ctypes.c_double()
        ic = ctypes.c_double()
        lib.mia_score_cut_fit(
            lens.ctypes.data_as(ctypes.c_void_p),
            scores.ctypes.data_as(ctypes.c_void_p),
            selv.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(n),
            ctypes.byref(s),
            ctypes.byref(ic),
        )
        return s.value, ic.value
    j = len(sel)
    xbar = _div(float(sum(fs.seq_len for fs in sel)), j)
    ybar = _div(float(sum(fs.score for fs in sel)), j)
    ssxy = sum((fs.seq_len - xbar) * (fs.score - ybar) for fs in sel) if j else 0.0
    ssxx = sum((fs.seq_len - xbar) ** 2 for fs in sel) if j else 0.0
    slope_bf = _div(ssxy, ssxx)
    intercept_bf = ybar - slope_bf * xbar

    max_slope_delta = 0.0
    for fs in sel:
        delta = _div(fs.score - ((slope_bf * fs.seq_len) + intercept_bf), fs.seq_len)
        if delta > max_slope_delta:
            max_slope_delta = delta

    intercept = intercept_bf
    if (slope_bf - max_slope_delta) > 0:
        slope = slope_bf - (max_slope_delta * 2.0)
    else:
        slope = slope_bf * (SCORE_CUTOFF_BUFFER / 100.0)
    return slope, intercept


def _resolve_cut(fsdb: FSDB, score_cut_set: bool, s: float, n: float) -> tuple[float, float]:
    slope_def = 100.0
    if score_cut_set:
        slope, intercept = s, n
    else:
        slope, intercept = find_fsdb_score_cut(fsdb)
    if slope <= 0:  # NaN compares False, same as C
        slope = slope_def
    return slope, intercept


# --- cleaning / culling (src/mia.c:398-506) --------------------------------

def clean_FSDB(fsdb: FSDB) -> None:
    """Drop score<=0 reads once after initial alignment (src/mia.c:400-406)."""
    fsdb.fss = [fs for fs in fsdb.fss if fs.score > 0]


def find_alignable_len(fs: FragSeq, ref: RefSeq) -> int:
    """Read length minus overlap with reference 'N's, floored at
    MIN_ALIGNABLE_LEN (src/mia.c:69-91)."""
    alignable = fs.seq_len
    aln_end = min(fs.ae, ref.wrap_seq_len)
    for i in range(fs.as_, aln_end):
        if ref.seq[i] == "N":
            alignable -= 1
    return max(alignable, MIN_ALIGNABLE_LEN)


def cull_maln_from_fsdb(
    culled: MapAlignment,
    fsdb: FSDB,
    hard_cut: int,
    score_cut_set: bool,
    s: float,
    n: float,
) -> None:
    """Select unique reads into the culled maln; mark below-line reads
    dropped but keep them in the output (src/mia.c:418-506)."""
    slope, intercept = _resolve_cut(fsdb, score_cut_set, s, n)

    picked: list[AlnSeq] = []
    if hard_cut > 0:
        cuts = np.full(len(fsdb.fss), float(hard_cut))
    elif culled.distant_ref:
        cuts = _min_scores_batch(
            slope,
            intercept,
            np.fromiter(
                (find_alignable_len(fs, culled.ref) for fs in fsdb.fss),
                np.int32,
                len(fsdb.fss),
            ),
        )
    else:
        cuts = _min_scores_batch(
            slope,
            intercept,
            np.fromiter((fs.seq_len for fs in fsdb.fss), np.int32, len(fsdb.fss)),
        )
    for fs, min_score in zip(fsdb.fss, cuts):
        if fs.unique_best:
            picked.append(fs.front_asp)
            if fs.score < min_score:
                fs.front_asp.dropped = True
            if fs.back_asp is not None:
                picked.append(fs.back_asp)
                if fs.score < min_score:
                    fs.back_asp.dropped = True
    culled.set_aln_seqs(picked)

    # recompute the shared max-insert array from surviving reads: one pass
    # over the records' insertions, where the reference rescans every read
    # for every gap column; dropped records count, and a column without a
    # gap keeps its value
    n = culled.ref.seq_len
    longest: dict[int, int] = {}
    for a in culled.aln_seqs:
        for k, ins in a.ins.items():
            i = a.start + k
            if a.start < i <= a.end and 0 <= i < n and len(ins) > longest.get(i, 0):
                longest[i] = len(ins)
    gaps = culled.ref.gaps[:n]
    live = gaps > 0
    gaps[live] = 0
    for i, g in longest.items():
        if live[i]:
            gaps[i] = g


# --- read collapsing (src/mia.c:105-396) -----------------------------------

_QBASE = {b: i for i, b in enumerate("ACGT")}


def init_QSSP(fs: FragSeq) -> None:
    """Quality pileup [4, INIT_ALN_SEQ_LEN+1] uint32 (src/mia.c:113-138)."""
    fs.qss = np.zeros((4, INIT_ALN_SEQ_LEN + 1), dtype=np.uint32)
    for i in range(fs.seq_len):
        b = _QBASE.get(fs.seq[i])
        if b is not None:
            q = ord(fs.qual[i]) if i < len(fs.qual) else 0
            # unsigned wraparound like the reference's unsigned int sums
            fs.qss[b, i] += np.uint32((q - 33) & 0xFFFFFFFF)


def best_base_at_pos(qss: np.ndarray, i: int) -> str:
    best_base, best = "A", qss[0, i]
    for b, ch in ((1, "C"), (2, "G"), (3, "T")):
        if qss[b, i] > best:
            best_base, best = ch, qss[b, i]
    return "N" if best == 0 else best_base


def add_fs(cfs: FragSeq, fs: FragSeq) -> None:
    """Meld ``fs`` into the collapsing read ``cfs`` (src/mia.c:140-204)."""
    if fs.ae > cfs.ae:
        if (fs.ae - cfs.as_) > INIT_ALN_SEQ_LEN:
            print(
                f"Collapsing {cfs.id} and {fs.id} exceeds maximal sequence "
                'length. Increase "INIT_ALN_SEQ_LEN"',
                file=sys.stderr,
            )
            return
        cfs.seq_len += fs.ae - cfs.ae
        cfs.ae = fs.ae

    offset = fs.as_ - cfs.as_
    if fs.qss is None:
        for i in range(fs.seq_len):
            b = _QBASE.get(fs.seq[i])
            if b is not None:
                q = ord(fs.qual[i]) if i < len(fs.qual) else 0
                cfs.qss[b, offset + i] += np.uint32((q - 33) & 0xFFFFFFFF)
    else:
        cfs.qss[:, offset : offset + fs.seq_len] += fs.qss[:, : fs.seq_len]
        fs.qss = None

    cfs.seq = "".join(best_base_at_pos(cfs.qss, i) for i in range(cfs.seq_len))
    cfs.num_inputs += fs.num_inputs
    fs.num_inputs = 0


def collapse_FSDB(
    fsdb: FSDB, hard_cut: int, score_cut_set: bool, s: float, n: float
) -> None:
    """Merge duplicate groups (sorted, unique_best-marked) into synthetic
    reads (src/mia.c:314-396)."""
    slope, intercept = _resolve_cut(fsdb, score_cut_set, s, n)

    fss = fsdb.fss
    if hard_cut > 0:
        cuts = np.full(len(fss), float(hard_cut))
    else:
        cuts = _min_scores_batch(
            slope, intercept,
            np.fromiter((fs.seq_len for fs in fss), np.int32, len(fss)),
        )
    i = 0
    while i < len(fss):
        cfs = fss[i]
        if cfs.qss is None:
            init_QSSP(cfs)
        i += 1
        while i < len(fss) and not fss[i].unique_best:
            fs = fss[i]
            if fs.score >= cuts[i]:
                add_fs(cfs, fs)
            i += 1

    fsdb.fss = [fs for fs in fss if fs.num_inputs > 0]


# --- PSSM depth-code assignment (src/fsdb.c:534-619) -----------------------

def _asp_len(asp: AlnSeq) -> int:
    return (asp.end - asp.start + 1) + sum(len(v) for v in asp.ins.values())


def _smp_segment(asp: AlnSeq, act0: int, base: int, total: int, depth: int) -> tuple[str, int]:
    """Vectorised depth-code assignment for one segment.

    Per column: act += len(ins[pos]); dff = base + act; dfb = total-act-1;
    emit 'A'+clip rule; act += (seq[pos] != '-').  Returns (smp, final act)."""
    span = asp.end - asp.start + 1
    s = np.frombuffer(asp.seq.encode("latin-1"), np.uint8)[:span]
    nongap = (s != ord("-")).astype(np.int64)
    ins_add = np.zeros(span, np.int64)
    for pos, v in asp.ins.items():
        if pos < span:
            ins_add[pos] = len(v)
    act = act0 + np.cumsum(ins_add) + np.concatenate(([0], np.cumsum(nongap)[:-1]))
    dff = base + act
    dfb = total - act - 1
    code = np.where(dff <= depth, dff, np.where(dfb < depth, 2 * depth - dfb, depth))
    smp = (ord("A") + code).astype(np.uint8).tobytes().decode("latin-1")
    return smp, int(act0 + ins_add.sum() + nongap.sum())


@lru_cache(maxsize=1024)
def _plain_smp(span: int, depth: int) -> str:
    """Depth-code string for an unsplit, indel-free read of ``span`` bases:
    the act counter then equals the column index, so the code profile is a
    pure function of length (the overwhelmingly common case — computing it
    once per length removes the per-read numpy dispatch cost)."""
    i = np.arange(span, dtype=np.int64)
    dfb = span - i - 1
    code = np.where(i <= depth, i, np.where(dfb < depth, 2 * depth - dfb, depth))
    return (ord("A") + code).astype(np.uint8).tobytes().decode("latin-1")


def pop_smp_from_FSDB(fsdb: FSDB, depth: int) -> None:
    """Write 'A'+depth codes per aligned position into each AlnSeq's smp
    string, spanning front/back segments of wrapped reads
    (src/fsdb.c:542-619)."""
    for fs in fsdb.fss:
        front, back = fs.front_asp, fs.back_asp
        if front is None:
            continue
        if back is None and not front.ins and "-" not in front.seq:
            front.smp = _plain_smp(front.end - front.start + 1, depth)
            continue
        front_len = _asp_len(front)
        back_len = _asp_len(back) if back is not None else 0
        total = front_len + back_len

        front.smp, act = _smp_segment(front, 0, 0, total, depth)
        if back is not None:
            back.smp, _ = _smp_segment(back, act, front_len, total, depth)


# --- fsdb insertion (src/fsdb.c:178-231, 622-663) --------------------------

def add_virgin_fs2fsdb(fs: FragSeq, fsdb: FSDB) -> None:
    """Trim + revcom-normalise a freshly aligned read, then copy it into the
    database (src/fsdb.c:194-231)."""
    if fs.trimmed:
        fs.seq = fs.seq[: fs.trim_point + 1]
        fs.qual = fs.qual[: fs.trim_point + 1]
        fs.seq_len = fs.trim_point + 1
    if fs.rc and fs.strand_known:
        fs.seq = revcom(fs.seq[: fs.seq_len])
        fs.qual = fs.qual[: fs.seq_len][::-1]
    # the reference copies the struct into the DB array (src/fsdb.c:622-663);
    # here the streamed FragSeq is never touched again after insertion, so
    # the DB owns the object itself (copy.copy was ~35% of the merge cost)
    fs.qss = None
    fsdb.add(fs)


def write_fastq(path: str, fsdb: FSDB) -> None:
    """Dump the read DB as fastq (src/fsdb.c:392-419)."""
    with open(path, "w") as f:
        for fs in fsdb.fss:
            rc = "R" if fs.rc else "F"
            tr = "T" if fs.trimmed else "U"
            f.write(f"@{fs.id} {rc} {tr}\n{fs.seq}\n+{fs.id}\n{fs.qual}\n")
