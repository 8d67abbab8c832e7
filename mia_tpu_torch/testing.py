"""Seeded scoring entries for checking the scorer against its references.

Shared by the tests and ``chip_smoke.py``: numpy arrays made from a seed, so
the JAX package, the plain PyTorch version and the CUDA kernel all see the
same inputs.  The batches cover the edge cases of the DP: reads of length 1
and of the full row count, entries whose band is empty (all columns masked),
argmax ties (a homopolymer stretch of the reference against homopolymer
reads), masks of all 16 intervals, read code 4 (N), and both PSSM slots.
The ``-h`` batches add homopolymer-rich references and reads: reads cut
from the reference with runs grown and shrunk, and runs of 32 bases or more
(past the TPU ring's reach) in both.
"""
from __future__ import annotations

import numpy as np

from .core.entries import MAX_INTERVALS, WIN_W
from .ops.pssm import init_flatsubmat
from .utils.encoding import BASE2INX, encode_seq, revcom

from .core.torch_engine import hp_state_numpy, padded_state_numpy
from .ops.dp_cuda import STRAND_COLS_PER_THREAD, STRAND_THREADS

_TIE_LO, _TIE_HI = 600, 1400   # homopolymer stretch (code 0) of the reference


def _pssms(rng) -> tuple[np.ndarray, np.ndarray]:
    flat = init_flatsubmat().astype(np.int32)
    return (
        (flat + rng.integers(-40, 40, (31, 5, 5))).astype(np.int32),
        (flat + rng.integers(-40, 40, (31, 5, 5))).astype(np.int32),
    )


def random_entries(E: int, L: int, seed: int = 0, len1: int = 2400) -> dict:
    """A batch of E entries with L read rows against a random two-strand
    reference of ``len1`` columns: the keys are ``entries_core_plain``'s
    arguments (refs, sms, ref_sel, starts, ivl, s2c, lengths, smidx) plus
    ``len1``."""
    rng = np.random.default_rng(seed)
    fw = rng.integers(0, 4, len1).astype(np.int8)
    rc = rng.integers(0, 4, len1).astype(np.int8)
    fw[_TIE_LO:_TIE_HI] = 0
    rc[_TIE_LO:_TIE_HI] = 0
    sm_a, sm_b = _pssms(rng)
    refs, sms = padded_state_numpy(fw, rc, len1, sm_a, sm_b)

    ref_sel = rng.integers(0, 2, E).astype(np.int8)
    starts = rng.integers(0, len1 - WIN_W // 2, E).astype(np.int32)
    smidx = rng.integers(0, 2, E).astype(np.int8)
    lengths = rng.integers(1, L + 1, E).astype(np.int32)
    s2c = rng.integers(0, 5, (E, L)).astype(np.int8)
    ivl = np.zeros((E, MAX_INTERVALS, 2), np.int32)
    kind = np.arange(E) % 6
    for e in range(E):
        k = kind[e]
        if k == 0:    # one band, as realignment sends
            lo = int(rng.integers(0, 40))
            ivl[e, 0] = (lo, int(rng.integers(lo + 1, WIN_W + 1)))
        elif k == 1:  # all 16 intervals
            cuts = np.sort(rng.choice(WIN_W + 1, 2 * MAX_INTERVALS, replace=False))
            ivl[e] = cuts.reshape(MAX_INTERVALS, 2)
        elif k == 2:  # a few intervals, some running past the window
            n = int(rng.integers(1, 5))
            cuts = np.sort(rng.integers(-8, WIN_W + 24, 2 * n))
            ivl[e, :n] = cuts.reshape(n, 2)
        elif k == 3:  # empty band: every column masked
            pass
        elif k == 4:  # argmax ties: homopolymer read in the homopolymer stretch
            starts[e] = int(rng.integers(_TIE_LO, _TIE_HI - WIN_W))
            s2c[e] = 0
            ivl[e, 0] = (0, WIN_W)
        else:         # full window open
            ivl[e, 0] = (0, WIN_W)
    lengths[::7] = 1
    lengths[3::11] = L
    return dict(refs=refs, sms=sms, ref_sel=ref_sel, starts=starts, ivl=ivl,
                s2c=s2c, lengths=lengths, smidx=smidx, len1=len1)


ENTRY_KEYS = ("refs", "sms", "ref_sel", "starts", "ivl", "s2c", "lengths", "smidx")


def oracle_entries(n: int, L: int, seed: int = 0, len1: int = 2400) -> dict:
    """Entries that the exact host DP (``dp_numpy.solve_sg``) can score over
    the whole reference strand: bands lie inside the window from column 2
    on (as realignment's windows start two columns before the band) and
    the window lies inside the reference."""
    d = random_entries(n, L, seed, len1)
    rng = np.random.default_rng(seed + 1)
    d["starts"] = rng.integers(0, len1 - WIN_W, n).astype(np.int32)
    d["ivl"][:] = 0
    for e in range(n):
        k = int(rng.integers(1, 4))
        cuts = np.sort(rng.choice(np.arange(2, WIN_W + 1), 2 * k, replace=False))
        d["ivl"][e, :k] = cuts.reshape(k, 2)
    d["lengths"] = rng.integers(8, L + 1, n).astype(np.int32)
    return d


HP_ENTRY_KEYS = ("refs", "refchr", "hpcs", "sms", "pengop", "b2i", "ref_sel", "starts",
                 "ivl", "s2chr", "lengths", "smidx")


def _runs_string(rng, n: int, long_every: int = 0) -> str:
    """A homopolymer-rich string of n bases: run lengths 1..8, and with
    ``long_every`` a run of 32-48 bases about every that many runs."""
    out: list[str] = []
    size, prev = 0, ""
    while size < n:
        b = "ACGT"[int(rng.integers(0, 4))]
        if b == prev:
            continue
        k = int(rng.integers(1, 9))
        if long_every and rng.integers(0, long_every) == 0:
            k = int(rng.integers(32, 49))
        out.append(b * k)
        size += k
        prev = b
    return "".join(out)[:n]


def _mutate_runs(rng, s: str) -> str:
    """Grow or shrink some homopolymer runs by 1-3 bases and substitute a
    few bases: the indels that -h scores at a discount."""
    out: list[str] = []
    i = 0
    while i < len(s):
        j = i
        while j < len(s) and s[j] == s[i]:
            j += 1
        k = j - i
        if rng.random() < 0.25:
            k = max(1, k + int(rng.choice([-3, -2, -1, 1, 2, 3])))
        run = [s[i]] * k
        for t in range(k):
            if rng.random() < 0.02:
                run[t] = "ACGTN"[int(rng.integers(0, 5))]
        out.extend(run)
        i = j
    return "".join(out)


def random_hp_entries(E: int, L: int, seed: int = 0, len1: int = 2400) -> dict:
    """``-h`` entries: :func:`random_entries`' strands, bands, lengths and
    PSSM selects, over a homopolymer-rich reference (an all-A stretch at
    the tie columns) and reads given as raw chars (pad 0).  The keys are
    ``entries_core_hp_plain``'s arguments (:data:`HP_ENTRY_KEYS`) plus
    ``len1``.  Kinds of read by entry: cut from the window's strand with
    runs grown and shrunk, a run of 32+ bases inside, all A (the ties
    entries), or homopolymer-rich noise."""
    d = random_entries(E, L, seed, len1)
    rng = np.random.default_rng(seed + 1000)
    fw = _runs_string(rng, len1, long_every=60)
    fw = fw[:_TIE_LO] + "A" * (_TIE_HI - _TIE_LO) + fw[_TIE_HI:]
    fw = fw[:40] + "N" + fw[41:]
    rc = revcom(fw)
    refs, sms = padded_state_numpy(encode_seq(fw), encode_seq(rc), len1, d["sms"][0],
                                   d["sms"][1])
    refchr, hpcs, pengop = hp_state_numpy((fw, rc), len1, refs.shape[1])
    strands = (fw, rc)
    s2chr = np.zeros((E, L), np.uint8)
    kind = np.arange(E) % 6
    for e in range(E):
        n = int(d["lengths"][e])
        r = rng.random()
        if kind[e] == 4:
            read = "A" * n
        elif r < 0.6:
            ws = int(d["starts"][e]) + int(rng.integers(0, 40))
            read = _mutate_runs(rng, strands[int(d["ref_sel"][e])][ws : ws + 2 * n + 8])
        elif r < 0.8:
            k = int(rng.integers(32, 60))
            read = _runs_string(rng, n // 2) + "ACGT"[int(rng.integers(0, 4))] * k
            read += _runs_string(rng, n)
        else:
            read = _runs_string(rng, n)
        read = (read + _runs_string(rng, n))[:n]
        s2chr[e, :n] = np.frombuffer(read.encode("latin-1"), np.uint8)
    d.update(refs=refs, refchr=refchr, hpcs=hpcs, pengop=pengop, b2i=BASE2INX.copy(),
             s2chr=s2chr, sms=sms)
    del d["s2c"]
    return d


def oracle_hp_entries(n: int, L: int, seed: int = 0, len1: int = 2400) -> dict:
    """``-h`` entries the exact host DP can score (bands and windows as in
    :func:`oracle_entries`): reads cut from the reference with runs grown and
    shrunk, every run shorter than 32 (the TPU ring's reach)."""
    from .core.entries import hp_routes_to_host

    d = random_hp_entries(n, L, seed, len1)
    o = oracle_entries(n, L, seed, len1)
    d.update(starts=o["starts"], ivl=o["ivl"], lengths=o["lengths"])
    rng = np.random.default_rng(seed + 2000)
    strands = [bytes(d["refchr"][s, :len1]).decode("latin-1") for s in (0, 1)]
    d["s2chr"][:] = 0
    for e in range(n):
        m = int(d["lengths"][e])
        read = ""
        while len(read) < m or hp_routes_to_host(read[:m]):
            ws = int(d["starts"][e]) + int(rng.integers(0, WIN_W - m // 2))
            read = _mutate_runs(rng, strands[int(d["ref_sel"][e])][ws : ws + 2 * m])
            read += _runs_string(rng, m)
        d["s2chr"][e, :m] = np.frombuffer(read[:m].encode("latin-1"), np.uint8)
    return d


def solve_sg_entry(d: dict, e: int) -> tuple[int, int]:
    """(best, aec) of entry ``e`` by the exact host DP, aec window-local;
    with ``-h`` (a dict of :func:`random_hp_entries`) the homopolymer
    candidates included."""
    from .core.driver import (init_alignment, set_hp_cols, set_hp_rows, set_seq1,
                                     set_seq2)
    from .ops import dp_numpy

    chars = np.array(list("ACGTN"))
    len1 = d["len1"]
    strand = int(d["ref_sel"][e])
    ws = int(d["starts"][e])
    hp = "s2chr" in d
    L = d["s2chr" if hp else "s2c"].shape[1]
    a = init_alignment(L, len1 + 16, False, hp)
    a.submat = d["sms"][int(d["smidx"][e])]
    if hp:
        set_seq1(a, bytes(d["refchr"][strand, :len1]).decode("latin-1"))
        set_seq2(a, bytes(d["s2chr"][e, : d["lengths"][e]]).decode("latin-1"))
        set_hp_rows(a)
        set_hp_cols(a)
    else:
        set_seq1(a, "".join(chars[d["refs"][strand, :len1]]))
        set_seq2(a, "".join(chars[d["s2c"][e, : d["lengths"][e]]]))
    a.sg5 = a.sg3 = True
    a.align_mask[: a.len1] = 0
    for lo, hi in d["ivl"][e]:
        if hi > lo:
            a.align_mask[ws + lo : ws + hi] = 1
    dp_numpy.solve_sg(a, do_trace=False)
    return int(a.best_score), int(a.aec) - ws


def dp_cells(lengths: np.ndarray) -> int:
    """DP cells a batch computes: rows 1..len-1 of the 384-column window."""
    return int(np.maximum(np.asarray(lengths, np.int64) - 1, 0).sum()) * WIN_W



# ---- adversarial entries and records for the kernels' edge cases ----

_EDGE_L = 256
# read lengths: the shortest reads, the row bound and its neighbours, no
# rows at all, and one more than the scorer takes (both keep row 0)
_EDGE_LENGTHS = (1, 2, 3, 24, 97, 255, 256, 0, 257)
# band shapes as window-local [lo, hi) intervals
_EDGE_BANDS = (
    (),                                               # closed window
    ((0, 1),), ((1, 2),), ((11, 12),), ((12, 13),), ((383, 384),),   # one open column
    ((5, 6), (7, 8), (9, 10), (200, 201), (202, 203)),    # bands one column wide
    ((0, 12),), ((12, 24),), ((3, 36),), ((0, 384),), ((372, 384),), ((100, 384),),
    ((24, 371),), ((0, 2),), ((0, 3),), ((2, 3),), ((1, 50),), ((0, 50),),
    ((0, 5), (6, 10), (12, 20), (21, 23), (25, 60)),  # gaps of one and two columns
    ((6, 18),), ((24, 36),), ((30, 42), (44, 47)),    # inside one lane, across two
    tuple((2 * k, 2 * k + 1) for k in range(MAX_INTERVALS)),           # all 16, one wide
    tuple((24 * k, 24 * k + 12) for k in range(MAX_INTERVALS)),        # all 16, lane-sized
    tuple((23 * k + 3, 23 * k + 20) for k in range(MAX_INTERVALS)),    # all 16, ragged
)


def _edge_layout(per_class: int = 3, turn: int = 0):
    """(bands, lengths, kinds) of the edge batch: every band shape with every
    read length (a class), and per entry what the read is: 0 cut from the
    window (a few substitutions and indels), 1 a homopolymer in the
    reference's homopolymer stretch (ties of the best value), 2 random.
    ``per_class`` entries a class: all three kinds, or fewer, the kinds then
    taking turns from class to class, starting ``turn`` further on."""
    bands, lengths, kinds = [], [], []
    for ib, b in enumerate(_EDGE_BANDS):
        for il, n in enumerate(_EDGE_LENGTHS):
            for k in range(per_class):
                bands.append(b)
                lengths.append(n)
                kinds.append((ib + il + k + turn) % 3 if per_class < 3 else k)
    return bands, np.array(lengths, np.int32), np.array(kinds)


_PER_ENTRY = ("ref_sel", "starts", "ivl", "s2c", "s2chr", "lengths", "smidx")


def take_entries(d: dict, picked) -> dict:
    """The entries ``picked`` of a batch of :func:`random_entries` or
    :func:`random_hp_entries`: the per-entry arrays cut, the state kept."""
    idx = np.asarray(picked, np.int64)
    return {k: np.ascontiguousarray(v[idx]) if k in _PER_ENTRY else v
            for k, v in d.items()}


def edge_entries(seed: int = 0, len1: int = 2400, per_class: int = 3) -> dict:
    """Entries (the keys of :func:`random_entries`, 256 rows) on the edges of
    the entry scorer: a closed window; one open column; bands one column
    wide; intervals that end on a multiple of 12 (a lane of the kernel) and
    on 384; column 0 open and closed; all 16 intervals; gaps of one and two
    closed columns inside a band; reads of 1, 2, 255 and 256 rows, a length
    of 0 and one above the row bound; equal best values within 12 columns
    and across them (a homopolymer read on a homopolymer stretch).  A third
    of the reads are cut from their window with substitutions and indels, so
    that gaps on both axes win cells.  ``per_class``: entries per (band,
    length) class, 3 (702 entries) or fewer (:func:`_edge_layout`; the seed
    then also turns the kinds)."""
    rng = np.random.default_rng(seed)
    bands, lengths, kinds = _edge_layout(per_class, seed)
    E, L = len(bands), _EDGE_L
    d = random_entries(E, L, seed, len1)
    d["lengths"] = lengths
    d["ivl"][:] = 0
    for e, b in enumerate(bands):
        for k, iv in enumerate(b):
            d["ivl"][e, k] = iv
        n = int(np.clip(lengths[e], 1, L))
        if kinds[e] == 1:
            d["starts"][e] = int(rng.integers(_TIE_LO, _TIE_HI - WIN_W))
            d["s2c"][e] = 0
        elif kinds[e] == 0:
            lo = b[0][0] if b else 0
            src = d["refs"][d["ref_sel"][e], d["starts"][e] + lo:][: 2 * n + 8]
            chars = "".join("ACGTN"[c] for c in src)
            read = encode_seq(mutate(chars, rng, 0.03, 0.03, alpha="ACGT") + "A" * n)[:n]
            d["s2c"][e, :n] = read
    return d


def edge_hp_entries(seed: int = 0, len1: int = 2400, per_class: int = 3) -> dict:
    """``-h`` entries (:data:`HP_ENTRY_KEYS`, 256 rows) on the edges of the
    ``-h`` scorer: :func:`edge_entries`' bands and lengths over a
    homopolymer-rich reference, reads with runs of 1, 2, 31, 32 and 33
    rows (the row reach is 32), windows that start inside a reference run
    (the run starts before the window) and on a run's first column, and
    reads cut from their window with runs grown and shrunk.  ``per_class``
    as in :func:`edge_entries`."""
    rng = np.random.default_rng(seed + 1000)
    bands, lengths, kinds = _edge_layout(per_class, seed)
    E, L = len(bands), _EDGE_L
    d = random_hp_entries(E, L, seed, len1)
    d["lengths"] = lengths
    d["ivl"][:] = 0
    strands = [bytes(d["refchr"][s, :len1]).decode("latin-1") for s in (0, 1)]
    d["s2chr"][:] = 0
    run_lens = (1, 2, 31, 32, 33)
    for e, b in enumerate(bands):
        for k, iv in enumerate(b):
            d["ivl"][e, k] = iv
        strand = strands[int(d["ref_sel"][e])]
        ws = int(d["starts"][e])
        if e % 3 == 0:      # the window starts inside a reference run
            while ws + 1 < len1 - WIN_W and strand[ws] != strand[ws - 1]:
                ws += 1
        elif e % 3 == 1:    # the window's first column starts a run
            while ws + 1 < len1 - WIN_W and strand[ws] == strand[ws - 1]:
                ws += 1
        d["starts"][e] = ws
        n = int(np.clip(lengths[e], 1, L))
        lo = b[0][0] if b else 0
        if kinds[e] == 1:   # runs of the edge lengths, one after the other
            read, k = "", e
            while len(read) < n:
                read += "ACGT"[k % 4] * run_lens[k % 5]
                k += 1
        elif kinds[e] == 0:
            read = _mutate_runs(rng, strand[ws + lo : ws + lo + 2 * n + 8])
        else:
            head = strand[ws + lo : ws + lo + n // 3]
            read = head + "ACGT"[e % 4] * run_lens[e % 5] + _runs_string(rng, n)
        read = (read + _runs_string(rng, n))[:n]
        d["s2chr"][e, :n] = np.frombuffer(read.encode("latin-1"), np.uint8)
    return d


def edge_records(seed: int = 0, n: int = 1300, big: bool = True, bits: int = 20):
    """A MapAlignment over ``n`` columns (three tiles of the counts kernel,
    the last one ragged) on the edges of the consensus counts: records that
    straddle every 512-column border, start below 0, run off the end, lie
    wholly outside, have a span of 0, are all gaps or all ``N``; and column
    ``n // 2`` hit by every one of 4,200 records under PSSM entries near
    +-2^``bits``, so that the column's sums pass +-2^32 and a private int32
    sum that is never flushed would overflow (at 2^30 after two records).
    Without ``big`` the PSSM is a noisy flat one and every sum fits int32."""
    from .core.types import AlnSeq, MapAlignment
    from .ops.pssm import revcom_submat

    rng = np.random.default_rng(seed)
    maln = MapAlignment()
    maln.ref.seq_len = n
    if big:
        top = 1 << bits
        near = rng.integers(top - 64, top, (31, 5, 5))
        maln.fpsm = (near * rng.choice([-1, 1], (31, 5, 5))).astype(np.int64)
        maln.fpsm[:, 0, 0] = top - 1      # A read as A: every depth the same sign
        maln.fpsm[:, 3, 3] = -top + 1     # T read as T
    else:
        maln.fpsm = (init_flatsubmat() + rng.integers(-40, 40, (31, 5, 5))).astype(np.int64)
    maln.rpsm = revcom_submat(maln.fpsm)
    recs = []

    def add(start, seq, rev=False, smp=None):
        smp = smp or "".join(chr(ord("A") + int(x)) for x in rng.integers(0, 31, len(seq)))
        recs.append(AlnSeq(id=f"r{len(recs)}", seq=seq, smp=smp, start=start,
                           end=start + len(seq) - 1, revcom=rev, dropped=False))

    def bases(k):
        return "".join(rng.choice(list("ACGT-N"), k, p=[.23, .23, .23, .23, .05, .03]))

    for border in range(0, n + 512, 512):
        for off in (-70, -1, 0, 1):
            add(border + off, bases(71), rev=bool(off & 1))
    add(-40, bases(30))            # wholly below 0
    add(-40, bases(41))            # its last base on column 0
    add(n - 1, bases(50))          # its first base on the last column
    add(n, bases(20))              # wholly past the end
    add(n + 900, bases(20))
    add(700, "")                   # span 0
    add(300, "-" * 60)
    add(400, "N" * 60, rev=True)
    add(-20, bases(n + 40))        # one record over every column and both ends
    mid = n // 2
    for i in range(4200):          # every one of them covers column mid
        seq = ("A" if i % 8 else "T") * 3
        add(mid - (i % 3), seq, rev=False, smp="AAA")
    maln.set_aln_seqs(recs)
    return maln


def random_records(n: int, R: int, seed: int = 0, mean_len: int = 60):
    """A MapAlignment of R aligned records over an n-column reference, for
    the consensus column counts: chars A, C, G, T, '-' and N, depths 0..30,
    both strands, some records running off either end of the reference and
    some dropped.  Built like the JAX package's device-consensus test."""
    from .core.types import AlnSeq, MapAlignment
    from .ops.pssm import init_flatsubmat, revcom_submat

    rng = np.random.default_rng(seed)
    maln = MapAlignment()
    maln.ref.seq_len = n
    maln.fpsm = (init_flatsubmat() + rng.integers(-40, 40, (31, 5, 5))).astype(np.int64)
    maln.rpsm = revcom_submat(maln.fpsm)
    lens = rng.integers(max(1, mean_len // 4), 2 * mean_len - mean_len // 4, R)
    total = int(lens.sum())
    chars = np.frombuffer(b"ACGT-N", np.uint8)[
        rng.choice(6, total, p=[0.23, 0.23, 0.23, 0.23, 0.05, 0.03])].tobytes().decode()
    depths = (ord("A") + rng.integers(0, 31, total)).astype(np.uint8).tobytes().decode()
    starts = rng.integers(-mean_len, n, R)
    revs = rng.integers(0, 2, R).astype(bool)
    dropped = rng.random(R) < 0.1
    recs, o = [], 0
    for i in range(R):
        ln = int(lens[i])
        recs.append(AlnSeq(id=f"r{i}", seq=chars[o : o + ln], smp=depths[o : o + ln],
                           start=int(starts[i]), end=int(starts[i]) + ln - 1,
                           revcom=bool(revs[i]), dropped=bool(dropped[i])))
        o += ln
    maln.set_aln_seqs(recs)
    return maln


# ---- ccheck: Myers pairs and the mt311-derived sample ----

_IUPAC = "ACGTRYSWKMBDHVN"


def resolve_iupac(seq: str, rng) -> str:
    """``seq`` upper-cased with every IUPAC code replaced by a compatible
    base drawn by ``rng``: a concrete sequence that matches ``seq``
    everywhere."""
    from .utils.encoding import IUPAC_BITMAP

    bm = IUPAC_BITMAP[np.frombuffer(seq.upper().encode(), np.uint8)]
    base_bm = IUPAC_BITMAP[np.frombuffer(b"ACGT", np.uint8)]
    ok = (bm[:, None] & base_bm[None, :]) != 0
    pick = np.argmax(ok * rng.random(ok.shape), axis=1)
    return np.frombuffer(b"ACGT", np.uint8)[pick].tobytes().decode()


def mutate(seq: str, rng, sub: float, indel: float, max_indel: int = 3,
           alpha: str = "ACGT") -> str:
    """``seq`` with a share ``sub`` of its bases substituted (by a different
    base) and a share ``indel`` of its positions starting an insertion or a
    deletion of 1..``max_indel`` bases."""
    out: list[str] = []
    i = 0
    while i < len(seq):
        r = rng.random()
        if r < indel / 2:      # deletion
            i += int(rng.integers(1, max_indel + 1))
            continue
        if r < indel:          # insertion before this base
            out.append("".join(rng.choice(list(alpha), int(rng.integers(1, max_indel + 1)))))
        c = seq[i]
        if rng.random() < sub:
            c = str(rng.choice([b for b in alpha if b != c.upper()]))
        out.append(c)
        i += 1
    return "".join(out)


def myers_pairs(seed: int = 0) -> list[tuple]:
    """(seq_a, mode, seq_b, maxd) cases for the Myers aligner: an IUPAC
    panel against concrete sequences, mutated copies with prefixes added or
    cut for the two prefix modes, identical and empty sequences, maxd too
    small (no alignment), pairs whose distance exceeds a length, and a
    pair that differs completely."""
    from .ops.myers import Mode

    rng = np.random.default_rng(seed)
    out: list[tuple] = []
    for mode in Mode:
        for _ in range(3):
            n = int(rng.integers(20, 160))
            a = "".join(rng.choice(list(_IUPAC), n))
            b = mutate(resolve_iupac(a, rng), rng, 0.05, 0.03)
            if mode == Mode.IS_PREFIX:
                b += "".join(rng.choice(list("ACGT"), int(rng.integers(0, 12))))
            elif mode == Mode.HAS_PREFIX:
                a += "".join(rng.choice(list("ACGT"), int(rng.integers(0, 12))))
            out.append((a, mode, b, max(8, (len(a) + len(b)) // 8)))
            out.append((a, mode, b, 3))                      # maxd too small
        for la, lb in ((0, 0), (0, 5), (4, 0), (3, 11), (12, 2)):  # d > a length
            a = "".join(rng.choice(list(_IUPAC), la))
            b = "".join(rng.choice(list("ACGT"), lb))
            out.append((a, mode, b, la + lb + 2))
        s = "".join(rng.choice(list("ACGT"), 50))
        out.append((s, mode, s, 5))                          # identical
        out.append(("A" * 40, mode, "C" * 40, 60))           # all mismatches
    return out


def edge_myers_pairs(seed: int = 0) -> list[tuple]:
    """(name, seq_a, mode, seq_b, maxd) cases on the edges of the Myers
    kernel (8 and then 16 bases a snake step, zero padding past both
    lengths, only the live band of diagonals): lengths 0, 1, 7-9, 15-17,
    31-33 and 63-65, each pair's wave-0 snake ending exactly at len_a and
    len_b, at len_a only or at len_b only, the nine (ending, mode)
    combinations all taken; runs of
    ``N`` (bitmap 15, matching every base) on either side, so snakes run to
    both ends; characters whose bitmap is 0 (matching nothing, themselves
    included); maxd = 1; maxd above len_a + len_b (the caller clips it);
    one side far longer than the other (the band's last lanes, where
    y = x - k is smallest: it stays >= 0 on every computed lane, and the
    kernel keeps the plain version's y < 0 return all the same); and a pair
    of 120,000-base sequences a few edits apart, whose bitmaps pass the
    kernel's shared memory, at maxd 8."""
    from .ops.myers import Mode

    rng = np.random.default_rng(seed)
    modes = list(Mode)

    def acgt(n: int) -> str:
        return "".join(rng.choice(list("ACGT"), n))

    out: list[tuple] = []
    for i, n in enumerate((0, 1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65)):
        a, tail = acgt(n), acgt(1 + i % 5)
        ends, mode = (i + 1) % 3, modes[(i // 3) % 3]
        if ends == 0:    # the snake ends at len_a and len_b together
            out.append((f"both_{n}", a, mode, a, 12))
        elif ends == 1:  # at len_a, with bases of b left
            out.append((f"end_a_{n}", a, mode, a + tail, 12))
        else:            # at len_b
            out.append((f"end_b_{n}", a + tail, mode, a, 12))
    for j, mode in enumerate(modes):
        n = 30 + 3 * j
        out.append((f"n_run_a_{n}", "N" * n, mode, acgt(n + j), 6))
        out.append((f"n_run_b_{n}", acgt(n), mode, "N" * (n - j), 6))
        mid = acgt(9) + "N" * 24 + acgt(10)
        out.append((f"n_run_mid_{j}", mid, mode, mid[:9] + acgt(24) + mid[33:], 4))
        x = acgt(10) + "X" + acgt(17)
        out.append((f"zero_bitmap_{j}", x, mode, x.replace("X", "-"), 8))
        s = acgt(20)
        out.append((f"maxd1_same_{j}", s, mode, s, 1))
        out.append((f"maxd1_sub_{j}", s, mode, s[:19] + ("A" if s[19] != "A" else "C"), 1))
        out.append((f"maxd_clipped_{j}", acgt(5 + j), mode, acgt(7), 100))
    out.append(("zero_bitmap_only", "-*.X" * 3, Mode.GLOBAL, "X.-*" * 2, 30))
    out.append(("b_long", acgt(3), Mode.GLOBAL, acgt(40), 60))
    out.append(("a_long", acgt(41), Mode.IS_PREFIX, acgt(2), 60))
    big = acgt(120_000)
    other = list(big)
    for at in rng.choice(len(big), 3, replace=False):
        other[at] = "ACGT"[("ACGT".index(other[at]) + 1) % 4]
    out.append(("past_smem", big, Mode.GLOBAL, "".join(other), 8))
    out.append(("past_smem_prefix", big[:-50], Mode.HAS_PREFIX, "".join(other), 8))
    return out


def myers_phase_pairs() -> list[tuple[str, str, str, int]]:
    """The Myers kernel's timed pairs (smoke phase 9): (name, mt311, other
    sequence, ccheck's maxd = max(len) / 10): an mt311-derived sample with
    ~1% divergence, one with ~5%, and an unrelated random sequence that
    runs every wave and finds no alignment."""
    from .cli.ccheck import load_mt311
    from .models.simulate import random_reference

    panel = load_mt311()
    reference, sample, _ = ccheck_sample(seed=31)
    pairs = [("1%", sample),
             ("5%", mutate(reference, np.random.default_rng(32), 0.05, 0.002)),
             ("unrelated", random_reference(16569, seed=33))]
    return [(name, panel, b, max(len(panel), len(b)) // 10) for name, b in pairs]


def ccheck_sample(seed: int = 0) -> tuple[str, str, str]:
    """(reference, sample, contaminant) derived from mt311: ``reference``
    resolves mt311's IUPAC codes to compatible bases, ``sample`` is that
    with ~1% substitutions and a few short indels (so mt311 and an assembly
    of it differ at well over 40 strongly diagnostic positions), and
    ``contaminant`` is another resolution of mt311 (the builtin panel,
    ``mia_tpu_torch/data/mt311.fa``: 16,619 columns, IUPAC codes and lower case
    included)."""
    from .cli.ccheck import load_mt311

    rng = np.random.default_rng(seed)
    panel = load_mt311()
    reference = resolve_iupac(panel, rng)
    sample = mutate(reference, rng, 0.01, 0.0005)
    return reference, sample, resolve_iupac(panel, rng)


# ---- the general-width last-row scorer and the assembly step ----

LAST_ROW_KEYS = ("s1c", "mask", "s2c", "lengths", "depths", "submat")
PILEUP_KEYS = ("s2c", "lengths", "starts", "depths", "strands", "fpsm", "rpsm")


def depths_numpy(lengths: np.ndarray, L: int) -> np.ndarray:
    """PSSM depth slot per (read, row) as [B, L] int32 (find_sm_depth,
    src/pssm.c:36-46; ``dp_torch.depths_for`` in numpy)."""
    from .constants import PSSM_DEPTH

    rows = np.arange(L)[None, :]
    from_back = np.asarray(lengths)[:, None] - (rows + 1)
    d = np.where(rows < PSSM_DEPTH, rows,
                 np.where(from_back < PSSM_DEPTH, 2 * PSSM_DEPTH - from_back, PSSM_DEPTH))
    return np.clip(d, 0, 2 * PSSM_DEPTH).astype(np.int32)


def drawn_reads(rng, ref: str, B: int, lo: int, hi: int, sub: float):
    """B reads of lo..hi-1 bases drawn from ``ref`` with a share ``sub`` of
    their bases redrawn: (reads, start of each in ref)."""
    reads, at = [], []
    for _ in range(B):
        n = int(rng.integers(lo, hi))
        s = int(rng.integers(0, len(ref) - n))
        reads.append("".join(c if rng.random() > sub else str(rng.choice(list("ACGT")))
                             for c in ref[s : s + n]))
        at.append(s)
    return reads, at


def last_row_inputs(B: int, W: int, L: int, seed: int = 0, shared: bool = True) -> dict:
    """Inputs of ``dp_last_row`` / ``batch_last_row`` (:data:`LAST_ROW_KEYS`),
    as the JAX package's Pallas test draws them: a random reference of W
    columns (a few N), reads cut from it with 10% of their bases redrawn,
    masks alternately open and banded around the read's origin, a noisy
    PSSM.  Also a read of one base, one of L bases, a row with every column
    masked and one with only its last two columns open.  ``shared`` gives
    one reference row for the batch, else one per read."""
    rng = np.random.default_rng(seed)
    ref = "".join(rng.choice(list("ACGT"), W))
    sm = (init_flatsubmat() + rng.integers(-40, 40, (31, 5, 5))).astype(np.int32)
    reads, at = drawn_reads(rng, ref, B, min(3, L - 1), L, 0.1)
    if B > 2:
        reads[1] = reads[1][:1]
        reads[2] = (reads[2] * L)[:L]
    mask = np.ones((B, W), bool)
    for b in range(1, B, 2):
        mask[b] = False
        mask[b, max(at[b] - 10, 0) : at[b] + len(reads[b]) + 10] = True
    if B > 4:
        mask[3] = False
        mask[4] = False
        mask[4, W - 2 :] = True
    lengths = np.array([len(r) for r in reads], np.int32)
    s2c = np.full((B, L), 4, np.int32)
    for b, r in enumerate(reads):
        s2c[b, : len(r)] = encode_seq(r)
    s1c = encode_seq(ref).astype(np.int32)
    s1c[rng.integers(0, W, max(1, W // 50))] = 4
    if not shared:
        s1c = np.stack([np.roll(s1c, int(rng.integers(0, W))) for _ in range(B)])
    return dict(s1c=np.ascontiguousarray(s1c), mask=mask, s2c=s2c, lengths=lengths,
                depths=depths_numpy(lengths, L), submat=sm)


def fullwidth_inputs(B: int = 512, W: int = 17024, L: int = 256, seed: int = 21,
                     shared: bool = True) -> dict:
    """The full-width shape the JAX package's bench times its Pallas kernel
    at: B reads of 30..119 random bases against W open columns."""
    rng = np.random.default_rng(seed)
    s1c = rng.integers(0, 4, W if shared else (B, W)).astype(np.int32)
    lengths = rng.integers(30, 120, B).astype(np.int32)
    s2c = rng.integers(0, 4, (B, L)).astype(np.int32)
    sm = (init_flatsubmat() + rng.integers(-40, 40, (31, 5, 5))).astype(np.int32)
    return dict(s1c=s1c, mask=np.ones((B, W), bool), s2c=s2c, lengths=lengths,
                depths=depths_numpy(lengths, L), submat=sm)


def pileup_inputs(B: int, W: int, L: int, seed: int = 0) -> dict:
    """Inputs of ``pileup_counts`` (:data:`PILEUP_KEYS`): codes 0..4, both
    strands, starts that run off either end of the W columns."""
    from .ops.pssm import revcom_submat

    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, B).astype(np.int32)
    fpsm = (init_flatsubmat() + rng.integers(-40, 40, (31, 5, 5))).astype(np.int32)
    return dict(
        s2c=rng.integers(0, 5, (B, L)).astype(np.int32), lengths=lengths,
        starts=rng.integers(-L, W + L // 2, B).astype(np.int32),
        depths=depths_numpy(lengths, L), strands=rng.integers(0, 2, B).astype(bool),
        fpsm=fpsm, rpsm=revcom_submat(fpsm).astype(np.int32),
    )


def tie_counts(W: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(counts [W, 5], scores [W, 4]) int32 for the consensus call: empty
    columns, gap shares on both sides of the threshold and exactly on it,
    score ties between bases, and scores around MIN_SCORE_CONS."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6, (W, 5)).astype(np.int32)
    scores = rng.integers(-3, 3, (W, 4)).astype(np.int32) * 200 - 399
    counts[::7] = 0
    counts[1::7] = (1, 0, 1, 0, 2)            # gaps exactly half
    counts[2::7] = (1, 1, 1, 0, 2)            # gaps just under half
    scores[3::7] = 500                        # a four-way tie
    scores[4::7] = (-399, -400, -399, -400)   # on and below the score floor
    return counts, scores


def split_parts(counts: np.ndarray, scores: np.ndarray, n_parts: int, seed: int = 0,
                big: bool = False) -> tuple[list, list]:
    """``counts`` and ``scores`` cut into ``n_parts`` int32 arrays each whose
    int32 sum, wrapping, gives them back: the partial accumulators of
    ``n_parts`` dp shards.  The first parts are drawn in [0, 50), or with
    ``big`` in [-2^30, 2^30), where the running sums wrap; the last part
    makes up the rest."""
    rng = np.random.default_rng(seed)
    out = []
    for total in (counts, scores):
        lo, hi = (-2**30, 2**30) if big else (0, 50)
        parts = [rng.integers(lo, hi, total.shape, dtype=np.int64) for _ in range(n_parts - 1)]
        last = (total.astype(np.int64) - sum(parts, np.zeros(total.shape, np.int64))
                + 2**31) % 2**32 - 2**31
        out.append([p.astype(np.int32) for p in [*parts, last]])
    return out[0], out[1]


def wrapping_parts(W: int, n_parts: int, seed: int = 0) -> tuple[list, list]:
    """``n_parts`` (counts [W, 5], scores [W, 4]) int32 parts whose entries
    lie in +-[2^30, 1.5 2^30), so that the sums of two or more parts, the
    coverage and the gap test's products all wrap int32."""
    rng = np.random.default_rng(seed)
    counts = [rng.integers(2**30, 2**30 + 2**29, (W, 5)).astype(np.int32)
              for _ in range(n_parts)]
    scores = [(rng.integers(2**30, 2**30 + 2**29, (W, 4))
               * rng.choice([-1, 1], (W, 4))).astype(np.int32) for _ in range(n_parts)]
    return counts, scores


def aten_ops(fn, *args, **kwargs) -> tuple:
    """(``fn(*args, **kwargs)``, [(ATen operation, shapes of its tensor
    arguments)] of every operation the call dispatched, on any device).
    A hand-written kernel's launch is no ATen operation: only the tensors
    around it show."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    log = []

    class _Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            flat = tree_flatten((args, kwargs or {}))[0]
            log.append((str(func.overloadpacket),
                        [tuple(a.shape) for a in flat if isinstance(a, torch.Tensor)]))
            return func(*args, **(kwargs or {}))

    with _Log():
        out = fn(*args, **kwargs)
    return out, log


def step_inputs(B: int, W: int, L: int, seed: int = 0, sub: float = 0.05) -> tuple:
    """(s1c, mask, s2c, lengths, depths, fpsm, rpsm) for one assembly step:
    a random reference of W columns, all open, and B reads of 8..L-1 bases
    drawn from it with a share ``sub`` redrawn (the JAX package's sharded
    step test draws the same)."""
    from .ops.pssm import revcom_submat

    rng = np.random.default_rng(seed)
    ref = "".join(rng.choice(list("ACGT"), W))
    reads, _ = drawn_reads(rng, ref, B, 8, L, sub)
    lengths = np.array([len(r) for r in reads], np.int32)
    s2c = np.full((B, L), 4, np.int32)
    for b, r in enumerate(reads):
        s2c[b, : len(r)] = encode_seq(r)
    fpsm = init_flatsubmat().astype(np.int32)
    return (encode_seq(ref).astype(np.int32), np.ones((B, W), bool), s2c, lengths,
            depths_numpy(lengths, L), fpsm, revcom_submat(fpsm).astype(np.int32))


# ---- adversarial inputs for the last-row scorer and the pileup counts ----

def _edge_last_row_case(rng, W: int, L: int, shared: bool) -> dict:
    """16 reads against W columns on the edges of ``dp_last_row``
    (:data:`LAST_ROW_KEYS`): per read one mask shape or one length."""
    from .ops.dp_cuda import LAST_ROW_COLS as C

    B = 16
    s1c = rng.integers(0, 5, W).astype(np.int32)
    lo, hi = W // 4, max(W // 4 + 1, 3 * W // 4)
    s1c[lo:hi] = 0                       # a homopolymer stretch, for ties
    lengths = rng.integers(3, L + 1, B).astype(np.int32)
    lengths[6:10] = (0, 1, 2, L + 1)
    lengths[0] = L
    s2c = rng.integers(0, 5, (B, L)).astype(np.int32)
    for b in range(0, B, 2):             # cut from the reference, a few bases redrawn
        at = int(rng.integers(0, max(1, W - L)))
        n = min(L, W - at)
        s2c[b, :n] = np.where(rng.random(n) < 0.1, s2c[b, :n], s1c[at : at + n])
    s2c[10] = 0                          # homopolymer read on the stretch
    cols = np.arange(W)
    mask = np.ones((B, W), bool)
    mask[1] = False                      # every column closed
    mask[2] = cols == 0                  # only column 0 open
    mask[3] = cols >= W - 2              # only the last two open
    mask[4] = cols % 5 == 2              # bands one column wide
    mask[5] = ((cols + 1) % C) < 2       # two columns over every thread border
    mask[11] = cols >= 2                 # columns 0 and 1 closed
    mask[12] = cols < 2
    mask[13] = False
    for _ in range(3):
        a = int(rng.integers(0, W))
        mask[13, a : int(rng.integers(a, W + 1))] = True
    mask[14] = cols % 2 == 0             # every other column
    mask[15] = cols % C != C - 1         # each thread's last column closed
    if not shared:
        s1c = np.stack([np.roll(s1c, int(rng.integers(0, W))) for _ in range(B)])
        s1c[10] = 0
    sm = (init_flatsubmat() + rng.integers(-40, 40, (31, 5, 5))).astype(np.int32)
    return dict(s1c=np.ascontiguousarray(s1c), mask=mask, s2c=s2c, lengths=lengths,
                depths=depths_numpy(np.clip(lengths, 1, L), L), submat=sm)


def edge_last_row_inputs(seed: int = 0, shared: bool = True, L: int = 32,
                         wide: bool = False) -> list[tuple[str, dict, bool]]:
    """(name, inputs, sg5) cases on the edges of the general-width scorer:
    rows of 1, 2, 3, 31, 32, 33 columns, of 100 and 400 (neither a multiple
    of the kernel's 34 columns a thread) and, with ``wide``, of 2,300 (two
    warp borders of the register form, at 1,088 and 2,176).  Per case 16
    reads: lengths 0, 1, 2, L and L + 1; rows all closed, only column 0
    open, only the last two open, bands one column wide, a band over every
    thread border (and so every warp border), each thread's last column
    closed, columns 0 and 1 closed; a homopolymer read on a homopolymer
    stretch of the reference (ties).  ``sg5`` alternates from case to case."""
    rng = np.random.default_rng(seed)
    widths = (1, 2, 3, 31, 32, 33, 100, 400) + ((2300,) if wide else ())
    return [(f"W{W}", _edge_last_row_case(rng, W, L, shared), bool((i + seed) % 2 == 0))
            for i, W in enumerate(widths)]


def edge_pileup_inputs(seed: int = 0) -> list[tuple[str, dict, int, bool]]:
    """(name, inputs, W, in_range) cases on the edges of the pileup counts
    (:data:`PILEUP_KEYS`): reads across every border of the kernel's tiles
    (32 columns where W is small, 128 from W = 12,673 on), ``starts`` of -L,
    -1, 0, W - 1, W and far above, lengths 0 and above L, every read on one
    column, B of 0, 1 and one more than a block lists in a round, PSSM
    entries near 2^30 (the int32 sums wrap), and codes outside 0..4
    (``in_range`` False: the plain version drops such a base, the JAX
    package does not define it)."""
    from .ops.pssm import revcom_submat
    from .parallel.sharded import PILEUP_ROUND, PILEUP_TILE

    rng = np.random.default_rng(seed)
    L = 32

    def case(B, W, starts=None, lengths=None, big=False, L=L):
        if big:
            fpsm = (rng.integers(2**30 - 64, 2**30, (31, 5, 5))
                    * rng.choice([-1, 1], (31, 5, 5))).astype(np.int32)
        else:
            fpsm = (init_flatsubmat() + rng.integers(-40, 40, (31, 5, 5))).astype(np.int32)
        if lengths is None:
            lengths = rng.integers(1, L + 1, B)
        if starts is None:
            starts = rng.integers(-L, W + L // 2, B)
        lengths = np.asarray(lengths, np.int32)
        return dict(s2c=rng.integers(0, 5, (B, L)).astype(np.int32), lengths=lengths,
                    starts=np.asarray(starts, np.int32),
                    depths=depths_numpy(np.clip(lengths, 1, L), L),
                    strands=rng.integers(0, 2, B).astype(bool), fpsm=fpsm,
                    rpsm=revcom_submat(fpsm).astype(np.int32))

    out = []
    W = 400
    borders = [t - k for t in range(0, W + 32, 32) for k in (L - 1, 1, 0)]
    ends = [-L, -L + 1, -1, 0, W - 1, W, W + 5, 2**31 - 1, -2**31]
    starts = borders + ends
    lengths = np.full(len(starts), L)
    lengths[::7] = 0
    lengths[3::7] = L + 3
    out.append(("borders", case(len(starts), W, starts, lengths), W, True))
    W = 12673 + 128 * 2 + 77   # tiles of PILEUP_TILE columns, the last one ragged
    starts = [t - k for t in range(0, W + PILEUP_TILE, PILEUP_TILE) for k in (L - 1, 1)]
    out.append(("tile128", case(len(starts), W, starts, np.full(len(starts), L)), W, True))
    out.append(("one_column", case(64, 200, np.full(64, 77), np.full(64, 1)), 200, True))
    out.append(("B0", case(0, 300), 300, True))
    out.append(("B1", case(1, 300, [290], [L]), 300, True))
    B = PILEUP_ROUND + 37
    out.append(("long_list", case(B, 64, rng.integers(20, 30, B),
                                  rng.integers(1, 5, B), L=4), 64, True))
    out.append(("wrap", case(64, 40, rng.integers(0, 8, 64), big=True), 40, True))
    bad = case(48, 300)
    bad["s2c"][::3] = rng.choice([-7, -1, 5, 6, 2**31 - 1], bad["s2c"][::3].shape)
    out.append(("bad_codes", bad, 300, False))
    return out


# ---- the -h full-width scorer ----

HP_WIDE_KEYS = ("refs", "refchr", "hpcs", "submat", "pengop", "b2i", "strand", "win_lo",
                "ivl", "s2chr", "lengths")


def hp_wide_inputs(W: int, L: int, seed: int = 0, R: int = 16) -> dict:
    """Inputs of ``dp_cuda.dp_last_row_hp`` / ``dp_torch.last_row_hp_plain``
    (:data:`HP_WIDE_KEYS`, and ``width`` = W) on the edges of the ``-h``
    recurrence, over a homopolymer-rich two-strand reference of W + 300
    columns whose forward strand starts with a run of two bases, holds an
    all-A stretch (ties), a lowercase stretch and IUPAC codes (chars that
    differ where their codes are all 4).  R rows, alternately on each strand:

    * row 0 from column 0 (the run at columns 0-1), row 1 starting inside a
      reference run (its hp_col candidates from before the window dropped),
      the rest at random starts, two of them 100 columns before the
      strand's end (their columns past the state read its padding);
    * bands: the whole window, 16 one-column bands, a band ending well
      before W (a row narrower than the batch's), a few random intervals,
      none at all;
    * reads cut from the row's window with runs grown and shrunk, one with
      runs of 1, 2 and 31 bases, one all A on the all-A stretch (tied
      maxima), and lengths 1, 2 and L.  L is at least 37."""
    rng = np.random.default_rng(seed)
    len1 = W + 300
    fw = list(_runs_string(rng, len1))
    fw[:3] = "GG" + ("A" if fw[3] != "A" else "C")
    lo = len1 // 3
    fw[lo : lo + 400] = "A" * 400
    fw[2 * lo : 2 * lo + 120] = [c.lower() for c in fw[2 * lo : 2 * lo + 120]]
    for at in rng.integers(0, len1, max(2, len1 // 500)):
        fw[at] = "RYN"[int(rng.integers(0, 3))]
    fw = "".join(fw)
    rc = revcom(fw)
    sm = (init_flatsubmat() + rng.integers(-40, 40, (31, 5, 5))).astype(np.int32)
    refs, _ = padded_state_numpy(encode_seq(fw), encode_seq(rc), len1, sm)
    refchr, hpcs, pengop = hp_state_numpy((fw, rc), len1, refs.shape[1])
    strands = (fw, rc)
    strand = (np.arange(R) % 2).astype(np.int8)
    win_lo = rng.integers(0, len1 - W // 2, R).astype(np.int32)
    win_lo[0], strand[0] = 0, 0
    # a window that starts one column into a reference run of 3 or more
    runs = np.flatnonzero((hpcs[0, 1:len1 - 2] == hpcs[0, :len1 - 3])
                          & (hpcs[0, 1:len1 - 2] == hpcs[0, 2:len1 - 1]))
    win_lo[1], strand[1] = int(runs[len(runs) // 2]) + 1, 0
    win_lo[2:4] = len1 - 100
    ivl = np.zeros((R, MAX_INTERVALS, 2), np.int32)
    lengths = rng.integers(3, L + 1, R).astype(np.int32)
    s2chr = np.zeros((R, L), np.uint8)
    for r in range(R):
        k = r % 5
        if k in (0, 1):
            ivl[r, 0] = (0, W)
        elif k == 2:
            ivl[r, :, 0] = np.sort(rng.choice(W, MAX_INTERVALS, replace=False))
            ivl[r, :, 1] = ivl[r, :, 0] + 1
        elif k == 3:
            ivl[r, 0] = (int(rng.integers(0, 20)), max(30, W // 2))
        elif r % 10 == 4:
            n = 3
            ivl[r, :n] = np.sort(rng.integers(0, W + 1, 2 * n)).reshape(n, 2)
        s = strands[int(strand[r])]
        at = int(win_lo[r]) + int(rng.integers(0, max(1, min(W, len1 - int(win_lo[r])) - L)))
        read = _mutate_runs(rng, s[at : at + 2 * L]) + _runs_string(rng, L)
        s2chr[r] = np.frombuffer(read[:L].encode("latin-1"), np.uint8)
    # read runs of 1, 2 and 31 bases (L >= 37)
    runs_read = ("ACGG" + "T" * 31 + "CAG" + "ACGT" * L)[:L]
    s2chr[5] = np.frombuffer(runs_read.encode("latin-1"), np.uint8)
    lengths[5] = L
    # an all-A read on the all-A stretch: ties
    s2chr[6] = ord("A")
    win_lo[6], strand[6] = lo - 40, 0
    ivl[6] = 0
    ivl[6, 0] = (0, W)
    lengths[7], lengths[8], lengths[9] = 1, 2, L
    for r in range(R):
        s2chr[r, lengths[r]:] = 0
    return dict(refs=refs, refchr=refchr, hpcs=hpcs, submat=sm, pengop=pengop,
                b2i=BASE2INX.copy(), strand=strand, win_lo=win_lo, ivl=ivl, s2chr=s2chr,
                lengths=lengths, width=W)


# the edges of the -h band form, by name: what each row of hp_band_inputs is
HP_BAND_EDGES = (
    "band 384", "band 385", "open 384", "open 385", "at column 0", "at column 1",
    "source in another interval", "source in a closed gap", "touching and overlapping",
    "16 one-column intervals", "gaps of 1 and 2", "empty intervals", "no open column",
    "past the state", "read of 1", "read of 2", "band 768", "band 769", "band 1536",
    "band 3072", "band 3073", "source in the warp before", "run at a warp's first column",
)


def hp_band_inputs(L: int = 48, seed: int = 0, copies: int = 2) -> dict:
    """Inputs of ``dp_cuda.dp_last_row_hp`` (:data:`HP_WIDE_KEYS`, and
    ``width``, the widest row's window) whose rows are the band form's
    edges, :data:`HP_BAND_EDGES` in order, ``copies`` times over on fresh
    reads and strands: band columns (``entries.band_columns``) of exactly
    384 and 385 (one warp's limit), 768 and 769 (two warps'), 1,536, 3,072
    (the form's limit) and 3,073 in two runs, open columns of exactly 384
    and 385 from window column 0 (no closed column before them), a reference
    run at band columns 380 on, so that cells of a row's second warp take
    their hp_col source from its first, and one at band column 384, so that
    hp_row's left neighbour lies in the warp before, a band
    from window column 0 and from column 1, a cell whose
    hp_col source (the column before its reference run) lies in another
    interval or in a closed gap between two, touching and overlapping
    intervals, 16 one-column intervals, gaps of one and two closed columns,
    empty intervals beside a real one, no open column at all, a band past
    the strand state's end, and reads of 1 and 2 bases.  The reference is
    homopolymer-rich with runs of 6-12 bases every 40 columns; the reads are
    cut from each row's band with runs grown and shrunk, and those of the
    two source rows lose most of the run that spans their gap, so that the
    hp_col candidate from across it is live."""
    rng = np.random.default_rng(seed)
    len1 = 3000
    fw = list(_runs_string(rng, len1))
    for at in range(20, len1 - 20, 40):  # a run of 6-12 bases every 40 columns
        b = "ACGT"[int(rng.integers(0, 4))]
        k = int(rng.integers(6, 13))
        fw[at : at + k] = b * k
        if fw[at - 1] == b:
            fw[at - 1] = "ACGT"[("ACGT".index(b) + 1) % 4]
        if fw[at + k] == b:
            fw[at + k] = "ACGT"[("ACGT".index(b) + 2) % 4]
    fw = "".join(fw)[:len1]
    rc = revcom(fw)
    strands = (fw, rc)
    sm = (init_flatsubmat() + rng.integers(-40, 40, (31, 5, 5))).astype(np.int32)
    refs, _ = padded_state_numpy(encode_seq(fw), encode_seq(rc), len1, sm)
    refchr, hpcs, pengop = hp_state_numpy((fw, rc), len1, refs.shape[1])
    n = len(HP_BAND_EDGES)
    R = n * copies
    strand = (rng.integers(0, 2, R)).astype(np.int8)
    win_lo = np.zeros(R, np.int32)
    ivl = np.zeros((R, MAX_INTERVALS, 2), np.int32)
    lengths = np.full(R, L, np.int32)
    s2chr = np.zeros((R, L), np.uint8)
    for r in range(R):
        edge = HP_BAND_EDGES[r % n]
        s = strands[int(strand[r])]
        # a reference run of 6+ bases on this strand, 60 columns into a
        # window that starts at a random column
        runs = np.flatnonzero((hpcs[strand[r], 1:len1] != hpcs[strand[r], :len1 - 1])
                              & (np.arange(1, len1) > 500) & (np.arange(1, len1) < len1 - 500)) + 1
        starts = [int(x) for x in runs if hpcs[strand[r], x + 5] == x]
        run0 = starts[int(rng.integers(0, len(starts)))]
        run1 = run0 + 1 + int(np.flatnonzero(hpcs[strand[r], run0 + 1:] != run0)[0])
        run_at = 380 if edge == "source in the warp before" else (
            384 if edge == "run at a warp's first column" else 60)
        lo = run0 - run_at
        win_lo[r] = lo
        iv = []
        cut = None  # read: the window columns it is cut from
        if edge.startswith("band "):
            iv = [(2, 100), (150, 48 + int(edge.split()[1]))]
        elif edge == "source in the warp before":
            # the run at window (= band) columns [380, 380 + k): the cells of
            # the row's second warp take hp_col from column 379, in its first
            k = run1 - run0
            iv = [(2, 700)]
            cut = (run_at - L // 2, run_at + k + 60)
        elif edge == "run at a warp's first column":
            iv = [(2, 700)]
            cut = (run_at - L // 2, run_at + 60)
        elif edge in ("open 384", "open 385"):
            win_lo[r] = 0
            iv = [(0, 200), (200, 384 if edge == "open 384" else 385)]
        elif edge == "at column 0":
            win_lo[r] = 0
            iv = [(0, 90), (150, 200)]
        elif edge == "at column 1":
            win_lo[r] = 0
            iv = [(1, 120)]
        elif edge in ("source in another interval", "source in a closed gap"):
            # the run at window columns [60, 60 + k); the cells of its last
            # columns open, the column before it (59) open or not
            k = run1 - run0
            end = 59 if edge == "source in a closed gap" else 60
            iv = [(2, end), (60 + k - 3, 60 + k + 80)]
            cut = (10, 60 + k + 60)
        elif edge == "touching and overlapping":
            iv = [(2, 50), (50, 90), (40, 70), (120, 160), (150, 155)]
        elif edge == "16 one-column intervals":
            iv = [(2 + 7 * i, 3 + 7 * i) for i in range(MAX_INTERVALS)]
        elif edge == "gaps of 1 and 2":
            iv = [(2, 40), (41, 80), (82, 130), (133, 170)]
        elif edge == "empty intervals":
            iv = [(30, 30), (2, 100), (90, 60)]
        elif edge == "no open column":
            iv = [(40, 40), (70, 20)]
        elif edge == "past the state":
            win_lo[r] = refs.shape[1] - 120
            iv = [(2, 200)]
        elif edge in ("read of 1", "read of 2"):
            iv = [(2, 150)]
            lengths[r] = 1 if edge == "read of 1" else 2
        for i, (a, b) in enumerate(iv):
            ivl[r, i] = (a, b)
        valid = [(a, b) for a, b in iv if a < b] or [(2, 60)]
        a0, b0 = cut or (min(a for a, _ in valid), max(b for _, b in valid))
        at = min(int(win_lo[r]) + a0 + int(rng.integers(0, 8)), len1 - 1)
        piece = s[at : at + max(L, b0 - a0) + 20]
        if cut and edge != "run at a warp's first column":
            # most of the run spanning the gap goes: a homopolymer deletion
            # that hp_col scores from the column before the run
            k = run1 - run0
            rs = int(win_lo[r]) + run_at - at
            piece = piece[:rs] + piece[rs] * 2 + piece[rs + k :]
        else:
            piece = _mutate_runs(rng, piece)
        read = (piece + _runs_string(rng, L))[:L]
        s2chr[r] = np.frombuffer(read.encode("latin-1"), np.uint8)
        s2chr[r, lengths[r]:] = 0
    width = int(max(int(ivl[:, :, 1].max()), 1))
    return dict(refs=refs, refchr=refchr, hpcs=hpcs, submat=sm, pengop=pengop,
                b2i=BASE2INX.copy(), strand=strand, win_lo=win_lo, ivl=ivl, s2chr=s2chr,
                lengths=lengths, width=width)


# ---- the band form of the general-width scorer ----

BAND_KEYS = ("refs", "submat", "strand", "win_lo", "ivl", "s2c", "lengths")

# the edges of the plain band form, by name: what each row of band_inputs is
BAND_EDGES = (
    "band 384", "band 385", "open 384", "open 385", "at column 0", "at column 1",
    "touching and overlapping", "16 one-column intervals", "gaps of 1 and 2",
    "empty intervals", "no open column", "past the state", "read of 1", "read of 2",
    "wrapping both ends", "wrapping both ends, wide", "band 768", "band 769",
    "band 1536", "band 3072", "band 3073",
)


def band_inputs(L: int = 48, seed: int = 0, copies: int = 2) -> dict:
    """Inputs of ``dp_cuda.dp_last_row_strand`` (:data:`BAND_KEYS`, and
    ``width``, the widest row's window) whose rows are the plain band form's
    edges, :data:`BAND_EDGES` in order, ``copies`` times over on fresh reads
    and strands: band columns (``entries.band_columns``) of exactly 384 and
    385 (one warp's limit and one past it), 768 and 769 (two warps'), 1,536
    and 3,072 (four and eight warps', the form's limit) and 3,073 (one past
    it) in two runs, open columns of 384 and 385
    many from window column 0 (no closed column before them), a band from
    window column 0 and from column 1, touching and overlapping intervals,
    16 one-column intervals, gaps of one and two closed columns, empty
    intervals beside a real one, no open column at all, a band past the
    strand state's end, reads of 1 and 2 bases, and a window over a whole
    circular strand whose band holds its two ends (as a read across the
    origin gets), once narrow and once over 384 columns.  The reference is random with a few N, 3,000 columns
    and its first 400 again after them (a circular strand's wrap, as pass 1
    lays it out); the reads are cut from each row's band with about 6% of
    their bases redrawn, and the wrapping rows' across the origin."""
    rng = np.random.default_rng(seed)
    base, wrap = 3000, 400
    fw = "".join(rng.choice(list("ACGT"), base))
    fw = "".join("N" if rng.random() < 0.002 else c for c in fw)
    rc = revcom(fw)
    fw, rc = fw + fw[:wrap], rc + rc[:wrap]
    len1 = base + wrap
    strands = (fw, rc)
    sm = (init_flatsubmat() + rng.integers(-40, 40, (31, 5, 5))).astype(np.int32)
    refs, _ = padded_state_numpy(encode_seq(fw), encode_seq(rc), len1, sm)
    n = len(BAND_EDGES)
    R = n * copies
    strand = rng.integers(0, 2, R).astype(np.int8)
    win_lo = np.zeros(R, np.int32)
    ivl = np.zeros((R, MAX_INTERVALS, 2), np.int32)
    lengths = np.full(R, L, np.int32)
    s2c = np.full((R, L), 4, np.int32)
    for r in range(R):
        edge = BAND_EDGES[r % n]
        s = strands[int(strand[r])]
        win_lo[r] = int(rng.integers(0, len1 - 1200))
        read = None
        if edge.startswith("band "):
            k = int(edge.split()[1])
            iv = [(2, 100), (150, 48 + k)]  # band columns 0..99, then 148..47 + k
            if k > 768:
                win_lo[r] = int(rng.integers(0, max(len1 - 48 - k, 1)))
        elif edge.startswith("open "):
            win_lo[r] = 0
            k = int(edge.split()[1])
            iv = [(0, 200), (200, k)]
        elif edge == "at column 0":
            win_lo[r] = 0
            iv = [(0, 90), (150, 200)]
        elif edge == "at column 1":
            win_lo[r] = 0
            iv = [(1, 120)]
        elif edge == "touching and overlapping":
            iv = [(2, 50), (50, 90), (40, 70), (120, 160), (150, 155)]
        elif edge == "16 one-column intervals":
            iv = [(2 + 7 * i, 3 + 7 * i) for i in range(MAX_INTERVALS)]
        elif edge == "gaps of 1 and 2":
            iv = [(2, 40), (41, 80), (82, 130), (133, 170)]
        elif edge == "empty intervals":
            iv = [(30, 30), (2, 100), (90, 60)]
        elif edge == "no open column":
            iv = [(40, 40), (70, 20)]
        elif edge == "past the state":
            win_lo[r] = refs.shape[1] - 120
            iv = [(2, 200)]
        elif edge in ("read of 1", "read of 2"):
            iv = [(2, 150)]
            lengths[r] = 1 if edge == "read of 1" else 2
        else:  # wrapping both ends: the k-mers of a read across the origin
            # hit around the origin's two copies, at the strand's start and
            # in its wrap
            win_lo[r] = 0
            slack = 40 if edge == "wrapping both ends" else 200
            tail = int(rng.integers(L // 3, 2 * L // 3 + 1))
            head = L - tail
            iv = [(base - tail - slack, base + head + slack), (0, head + slack)]
            read = s[base - tail : base + head]
        for i, (a, b) in enumerate(iv):
            ivl[r, i] = (a, b)
        if read is None:
            valid = [(a, b) for a, b in iv if a < b] or [(2, 60)]
            a0 = min(a for a, _ in valid)
            at = min(int(win_lo[r]) + a0 + int(rng.integers(0, 8)), len1 - L)
            read = s[at : at + L]
        read = "".join(c if rng.random() > 0.06 else str(rng.choice(list("ACGT")))
                       for c in read)
        s2c[r, : lengths[r]] = encode_seq(read)[: lengths[r]]
    width = int(max(int(ivl[:, :, 1].max()), 1))
    return dict(refs=refs, submat=sm, strand=strand, win_lo=win_lo, ivl=ivl, s2c=s2c,
                lengths=lengths, width=width)


# ---- the strand form of the general-width scorer ----

# the edges of the strand form, by name: what each row of strand_inputs is
STRAND_EDGES = (
    "whole strand", "16 intervals", "wrapping both ends", "tie in the wrap",
    "tie in a repeat", "no open column", "read of 1", "past the state",
)


def strand_inputs(L: int = 48, seed: int = 0, copies: int = 2, base: int = 2000) -> dict:
    """Inputs of ``dp_cuda.dp_last_row_strand`` (:data:`BAND_KEYS`, and
    ``width``, the widest row's window) whose rows are the strand form's
    edges, :data:`STRAND_EDGES` in order, ``copies`` times over on fresh
    reads and strands: windows over a whole circular strand of ``base``
    columns and its wrap (400 columns, or ``base`` / 5 if less), in one
    interval, in 16 with gaps of one to three closed columns, and as the
    two ends of a read across the origin; a read from the strand's first
    columns, which ties with its copy in the wrap, and one from a segment
    the strand holds twice (both ties: the first column must win); no open
    column; a read of 1 base; and a window past the strand state's end.
    The reads are cut from the strand with about 6% of their bases redrawn
    (the ties' exact)."""
    rng = np.random.default_rng(seed)
    wrap = min(400, base // 5)
    fw = list(rng.choice(list("ACGT"), base))
    seg = L + 40  # a repeat: the strand's columns [300, 300 + seg) again at base / 2
    fw[base // 2 : base // 2 + seg] = fw[300 : 300 + seg]
    fw = "".join("N" if rng.random() < 0.002 and not 250 < i < base // 2 + seg + 50 else c
                 for i, c in enumerate(fw))
    rc = revcom(fw)
    fw, rc = fw + fw[:wrap], rc + rc[:wrap]
    len1 = base + wrap
    strands = (fw, rc)
    sm = (init_flatsubmat() + rng.integers(-40, 40, (31, 5, 5))).astype(np.int32)
    refs, _ = padded_state_numpy(encode_seq(fw), encode_seq(rc), len1, sm)
    n = len(STRAND_EDGES)
    R = n * copies
    strand = rng.integers(0, 2, R).astype(np.int8)
    win_lo = np.zeros(R, np.int32)
    ivl = np.zeros((R, MAX_INTERVALS, 2), np.int32)
    lengths = np.full(R, L, np.int32)
    s2c = np.full((R, L), 4, np.int32)
    for r in range(R):
        edge = STRAND_EDGES[r % n]
        s = strands[int(strand[r])]
        iv = [(0, len1)]
        at = int(rng.integers(0, len1 - L))
        exact = False
        if edge == "16 intervals":
            cuts = np.sort(rng.choice(np.arange(50, len1 - 50), MAX_INTERVALS - 1, replace=False))
            edges = [0, *cuts.tolist(), len1]
            iv = [(edges[i] + (int(rng.integers(1, 4)) if i else 0), edges[i + 1])
                  for i in range(MAX_INTERVALS)]
        elif edge == "wrapping both ends":
            tail = int(rng.integers(L // 3, 2 * L // 3 + 1))
            at = base - tail
            iv = [(base - tail - base // 3, len1), (0, L - tail + base // 3)]
        elif edge == "tie in the wrap":
            at, exact = int(rng.integers(0, wrap - L)), True
        elif edge == "tie in a repeat":
            # only the forward strand holds the repeat where it was made
            strand[r], s, at, exact = 0, strands[0], 300 + int(rng.integers(0, 20)), True
        elif edge == "no open column":
            iv = [(40, 40), (70, 20)]
        elif edge == "read of 1":
            lengths[r] = 1
        elif edge == "past the state":
            win_lo[r] = refs.shape[1] - base // 2
            at = len1 - L
        for i, (a, b) in enumerate(iv):
            ivl[r, i] = (a, b)
        read = s[at : at + L]
        if not exact:
            read = "".join(c if rng.random() > 0.06 else str(rng.choice(list("ACGT")))
                           for c in read)
        s2c[r, : lengths[r]] = encode_seq(read)[: lengths[r]]
    width = int(max(int(ivl[:, :, 1].max()), 1))
    return dict(refs=refs, submat=sm, strand=strand, win_lo=win_lo, ivl=ivl, s2c=s2c,
                lengths=lengths, width=width)


def mixed_wide_inputs(L: int = 48, seed: int = 0, base: int = 19000) -> dict:
    """Inputs of ``dp_cuda.dp_last_row_strand`` (:data:`BAND_KEYS`, and
    ``width``) on one strand state whose rows take every form: the rows of
    :func:`strand_inputs` over a circular strand of ``base`` columns (whole
    strands, past 18,432 band columns for the default ``base``: the full
    form's), and, on the same state, rows of one interval of 150, 500, 1,000,
    2,000 and 3,000 columns (the band form's four classes) and of 4,000 and
    17,000 (the strand form's), each twice, the reads cut from their band.
    The rows come in no form's order."""
    d = strand_inputs(L, seed, copies=1, base=base)
    rng = np.random.default_rng([seed, 1])
    len1 = d["refs"].shape[1]
    widths = [w for w in (150, 500, 1000, 2000, 3000, 4000, 17000) for _ in range(2)]
    n = len(widths)
    strand = rng.integers(0, 2, n).astype(np.int8)
    win_lo = np.array([int(rng.integers(0, max(len1 - w - 10, 1))) for w in widths], np.int32)
    ivl = np.zeros((n, MAX_INTERVALS, 2), np.int32)
    ivl[:, 0, 0] = 2
    ivl[:, 0, 1] = 2 + np.array(widths)
    lengths = np.full(n, L, np.int32)
    s2c = np.full((n, L), 4, np.int32)
    for r, w in enumerate(widths):
        at = int(win_lo[r]) + 2 + int(rng.integers(0, w - L))
        codes = d["refs"][strand[r], at : at + L].astype(np.int32)
        noise = rng.random(len(codes)) < 0.06
        codes[noise] = rng.integers(0, 4, int(noise.sum()))
        s2c[r, : len(codes)] = codes
    rows = {"strand": strand, "win_lo": win_lo, "ivl": ivl, "s2c": s2c, "lengths": lengths}
    mix = rng.permutation(len(d["lengths"]) + n)
    out = {k: np.concatenate([d[k], rows[k]])[mix] for k in rows}
    return dict(refs=d["refs"], submat=d["submat"], **out,
                width=int(max(int(out["ivl"][:, :, 1].max()), 1)))


# ---- the -h strand form of the general-width scorer ----

# the band columns a CTA of the strand forms owns (csrc/dp_strand.cu)
STRAND_SLICE = STRAND_THREADS * STRAND_COLS_PER_THREAD

# the edges of the -h strand form, by name: what each row of hp_strand_inputs is
HP_STRAND_EDGES = (
    "whole strand", "16 intervals", "run across a slice border",
    "run at a slice's first column", "source not open", "run longer than a slice",
    "read run of 31", "read run of 32", "read run of 33", "wrapping both ends",
    "tie in the wrap", "past the state", "read of 1", "no open column",
)


def hp_strand_inputs(L: int = 48, seed: int = 0, copies: int = 2, base: int = 4000) -> dict:
    """Inputs of ``dp_cuda.dp_last_row_hp`` (:data:`HP_WIDE_KEYS`, and
    ``width``, the widest row's window) whose rows are the ``-h`` strand
    form's edges, :data:`HP_STRAND_EDGES` in order, ``copies`` times over on
    fresh reads and strands, every band past 3,072 columns.  The reference:
    a homopolymer-rich circular strand of ``base`` columns (runs of 6-12
    bases every 40 columns, and one of 1,400 A from ``base`` / 3 on the
    forward strand) and its wrap (400 columns).  Rows: windows over the
    whole strand in one interval and in 16 (gaps of one to three closed
    columns); windows placed so that a reference run of 6+ bases crosses
    the border of two 1,152-column slices (:data:`STRAND_SLICE`: the hp_col
    sources of the later slice's cells lie in the earlier one), starts at a
    slice's first column (hp_row's left neighbour in the slice before),
    and starts two columns before a border with the column before it
    closed (a source that is not open); a window whose band puts the long
    run over band columns 1,000-2,399, so that the third slice's cells take
    their source from the first (the run is longer than a slice), with
    reads of a run of 4, 31, 32 and 33 A's there (the read-run reach and
    its neighbours); the two ends of a read across the origin; a read from
    the strand's first columns, tied with its copy in the wrap; a window
    past the strand state's end; a read of 1 base; and no open column.
    The reads are cut from the row's window with runs grown and shrunk, the
    border rows' run shrunk to two bases (a homopolymer deletion that
    hp_col scores from the column before the run) or grown by three
    (hp_row); the tie's exact."""
    rng = np.random.default_rng(seed)
    wrap = min(400, base // 5)
    fw = list(_runs_string(rng, base))
    for at in range(20, base - 20, 40):  # a run of 6-12 bases every 40 columns
        b = "ACGT"[int(rng.integers(0, 4))]
        k = int(rng.integers(6, 13))
        fw[at : at + k] = b * k
        if fw[at - 1] == b:
            fw[at - 1] = "ACGT"[("ACGT".index(b) + 1) % 4]
        if fw[at + k] == b:
            fw[at + k] = "ACGT"[("ACGT".index(b) + 2) % 4]
    long_at, long_n = base // 3, 1400
    fw[long_at - 1], fw[long_at : long_at + long_n], fw[long_at + long_n] = "C", "A" * long_n, "G"
    fw = "".join(fw)[:base]
    rc = revcom(fw)
    fw, rc = fw + fw[:wrap], rc + rc[:wrap]
    len1 = base + wrap
    strands = (fw, rc)
    sm = (init_flatsubmat() + rng.integers(-40, 40, (31, 5, 5))).astype(np.int32)
    refs, _ = padded_state_numpy(encode_seq(fw), encode_seq(rc), len1, sm)
    refchr, hpcs, pengop = hp_state_numpy((fw, rc), len1, refs.shape[1])
    n = len(HP_STRAND_EDGES)
    R = n * copies
    strand = rng.integers(0, 2, R).astype(np.int8)
    win_lo = np.zeros(R, np.int32)
    ivl = np.zeros((R, MAX_INTERVALS, 2), np.int32)
    lengths = np.full(R, L, np.int32)
    s2chr = np.zeros((R, L), np.uint8)
    cols = np.arange(len1)
    for r in range(R):
        edge = HP_STRAND_EDGES[r % n]
        st = int(strand[r])
        s, h = strands[st], hpcs[st]
        iv = [(0, len1)]
        at = int(rng.integers(0, len1 - 2 * L))
        read = None
        if edge == "16 intervals":
            cuts = np.sort(rng.choice(np.arange(50, len1 - 50), MAX_INTERVALS - 1, replace=False))
            edges = [0, *cuts.tolist(), len1]
            iv = [(edges[i] + (int(rng.integers(1, 4)) if i else 0), edges[i + 1])
                  for i in range(MAX_INTERVALS)]
        elif edge in ("run across a slice border", "run at a slice's first column",
                      "source not open"):
            # a run of 6+ bases at window column wcol of a window that keeps
            # over 3,072 band columns; band column = window column here
            border = STRAND_SLICE * int(rng.integers(1, 3))
            wcol = {"run across a slice border": border - 3,
                    "run at a slice's first column": border,
                    "source not open": border - 2}[edge]
            starts = np.flatnonzero((h[1:len1 - 20] != h[: len1 - 21]) & (cols[1:len1 - 20] >= wcol)
                                    & (cols[1:len1 - 20] < len1 - 3100 + wcol)) + 1
            starts = [int(x) for x in starts if h[x + 5] == x and h[x + 12] != x]
            x = starts[int(rng.integers(0, len(starts)))]
            k = int(np.flatnonzero(h[x + 1:] != x)[0]) + 1
            win_lo[r] = x - wcol
            iv = [(0, len1 - int(win_lo[r]))]
            if edge == "source not open":
                iv = [(0, wcol - 1), (wcol, len1 - int(win_lo[r]))]
            grow = 3 if edge == "run at a slice's first column" else 2 - k
            lo = x - L // 2
            read = s[lo:x] + s[x] * (k + grow) + s[x + k : x + k + L]
        elif edge == "run longer than a slice" or edge.startswith("read run of "):
            # only the forward strand holds the long run where it was made
            strand[r], s = 0, strands[0]
            win_lo[r] = long_at - 1000
            iv = [(0, len1 - int(win_lo[r]))]
            run = 4 if edge == "run longer than a slice" else int(edge.split()[-1])
            read = (s[long_at - 10 : long_at] + "A" * run
                    + s[long_at + long_n : long_at + long_n + L])
        elif edge == "wrapping both ends":
            tail = int(rng.integers(L // 3, 2 * L // 3 + 1))
            at = base - tail
            iv = [(base - tail - base // 3, len1), (0, L - tail + base // 3)]
        elif edge == "tie in the wrap":
            read = s[(at := int(rng.integers(0, wrap - L))) : at + L]
        elif edge == "past the state":
            win_lo[r] = refs.shape[1] - len1 + 200
            at = len1 - L - 200
        elif edge == "read of 1":
            lengths[r] = 1
        elif edge == "no open column":
            iv = [(40, 40), (70, 20)]
        for i, (a, b) in enumerate(iv):
            ivl[r, i] = (a, b)
        if read is None:
            read = _mutate_runs(rng, s[at : at + 2 * L])
        read = (read + _runs_string(rng, L))[:L]
        s2chr[r] = np.frombuffer(read.encode("latin-1"), np.uint8)
        s2chr[r, lengths[r]:] = 0
    width = int(max(int(ivl[:, :, 1].max()), 1))
    return dict(refs=refs, refchr=refchr, hpcs=hpcs, submat=sm, pengop=pengop,
                b2i=BASE2INX.copy(), strand=strand, win_lo=win_lo, ivl=ivl, s2chr=s2chr,
                lengths=lengths, width=width)


def mixed_hp_wide_inputs(L: int = 48, seed: int = 0) -> dict:
    """Inputs of one ``dp_cuda.dp_last_row_hp`` call of every form
    (:data:`HP_WIDE_KEYS`, ``width``, and the split: ``n_band``,
    ``band_classes``, ``n_strand``) on one strand state, in the call's row
    order: band rows of one interval of 150, 500, 1,000, 2,000 and 3,000
    columns (the band form's four classes, as ``entries.wide_order``
    orders them), the rows of :func:`hp_strand_inputs` whose band passes
    3,072 columns (strand rows), and three more of its whole strands given
    to the full form, which any of the forms could take (``width``: their
    widest window)."""
    from .core.entries import BAND_ROW_COLS, band_columns

    d = hp_strand_inputs(L, seed, copies=2)
    rng = np.random.default_rng([seed, 2])
    n = len(HP_STRAND_EDGES)
    len1 = int((d["refchr"][0] != 0).sum())
    widths = (150, 500, 1000, 2000, 3000)
    nb = len(widths)
    strand = rng.integers(0, 2, nb).astype(np.int8)
    win_lo = np.array([int(rng.integers(0, max(len1 - w - 10, 1))) for w in widths], np.int32)
    ivl = np.zeros((nb, MAX_INTERVALS, 2), np.int32)
    ivl[:, 0, 0] = 2
    ivl[:, 0, 1] = 2 + np.array(widths)
    s2chr = np.zeros((nb, L), np.uint8)
    chars = d["refchr"]
    for r, w in enumerate(widths):
        at = int(win_lo[r]) + 2 + int(rng.integers(0, w - L))
        piece = bytes(chars[strand[r], at : at + 2 * L]).decode("latin-1")
        read = (_mutate_runs(rng, piece) + _runs_string(rng, L))[:L]
        s2chr[r] = np.frombuffer(read.encode("latin-1"), np.uint8)
    band = {"strand": strand, "win_lo": win_lo, "ivl": ivl, "s2chr": s2chr,
            "lengths": np.full(nb, L, np.int32)}
    # the strand rows: the first copy's; the full rows: three whole strands
    # of the second
    strd = np.flatnonzero(band_columns(d["ivl"][:n])[1] > BAND_ROW_COLS)
    take = np.r_[strd, n + np.array([0, 1, 2])]
    out = {k: np.concatenate([band[k], d[k][take]]) for k in band}
    return dict({k: d[k] for k in HP_WIDE_KEYS[:6]}, **out, n_band=nb,
                band_classes=(1, 1, 1, 2), n_strand=len(strd),
                width=int(out["ivl"][nb + len(strd):, :, 1].max()))
