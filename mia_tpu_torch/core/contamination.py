"""Contamination analysis engine (ccheck, src/ccheck.cc).

Pipeline: globally align the contaminant consensus vs the assembly with the
Myers O(ND) aligner; collect weakly/strongly diagnostic positions; pass 1
re-aligns each read to the lifted contaminant window with the mia DP and
upgrades weak positions that diagnose contamination to 'effective'; pass 2
classifies every read clean/dirt/conflict/nonsense by IUPAC consistency at
the surviving positions (with aDNA deamination leniency), joining circular
front/back segments; finally a Wilson 95% CI estimates the contamination
fraction.

The JAX package's ``mia_tpu/core/contamination.py`` with both device stages
on the port's device under ``--engine torch`` (the default here):

* the Myers alignment of the contaminant consensus against the assembly
  (``myers_diff_torch``: the wavefront kernel ``csrc/myers_waves.cu`` on a
  card, its plain PyTorch version on the CPU);
* the pass-1 read realignment (:func:`_realign_all`): every read whose
  lifted window fits the device window is scored by the port's
  :class:`~mia_tpu_torch.core.torch_engine.Pass1Scorer` (the fused entry
  kernel), and the host rebuilds the traceback (``BatchHost.finish``); the
  rest go to the native window solver and the per-read Python DP.

``--engine native`` and ``--engine numpy`` keep both stages on the host.
Unlike the JAX package, a device failure raises: neither stage falls back
to the host without a word.  ``device_entries`` / ``host_entries`` count the
reads realigned on the device and on the host under ``--engine torch``.
"""
from __future__ import annotations

import math
import sys
from bisect import bisect_left
from dataclasses import dataclass
from enum import IntEnum

import numpy as np

from ..ops.dp_numpy import (
    Alignment,
    dyn_prog,
    find_align_begin,
    max_sg_score,
    populate_pwaln_to_begin,
)
from ..ops.myers import UINT_MAX, Mode, myers_diff
from ..utils import profiling
from ..utils.encoding import IUPAC_BITMAP, encode_seq
from .driver import init_alignment, set_seq1, set_seq2
from .entries import L_MAX, MAX_INTERVALS, WIN_W, pack_s2c
from ..io.native import unavailable as native_unavailable
from .hostbatch import STATUS_OK, BatchHost
from .types import AlnSeq, MapAlignment

device_entries = 0
host_entries = 0


def reset_counts() -> None:
    global device_entries, host_entries
    device_entries = 0
    host_entries = 0

WEAK, EFFECTIVE, STRONG = 0, 1, 2


class Whatsit(IntEnum):
    unknown = 0
    clean = 1
    dirt = 2
    conflict = 3
    nonsense = 4


MAXWHATSITS = 5
LABELS = [
    "unclassified", "clean", "polluting", "conflicting", "nonsensical",
    "LB", "ML", "UB",
]


@dataclass
class Dp:
    consensus: str = "\0"
    assembly: str = "\0"
    contaminant: str = "\0"
    strength: int = WEAK


def compatible(x: str, y: str) -> bool:
    return (IUPAC_BITMAP[ord(x)] & IUPAC_BITMAP[ord(y)]) != 0


def is_strongly_diagnostic(a1: str, a2: str) -> bool:
    return a1 != "-" and a2 != "-" and not compatible(a1, a2)


def is_weakly_diagnostic(a1: str, a2: str) -> bool:
    return a1 != "-" and a2 != "-" and a1.upper() != a2.upper()


def is_transversion(a: str, b: str) -> bool:
    u = a.upper()
    v = b.upper()
    if u == "A":
        return v != "G"
    if u == "C":
        return v != "T"
    if u == "G":
        return v != "A"
    if u in ("T", "U"):
        return v != "C"
    return False


def consistent(adna: bool, x: str, y: str) -> bool:
    """IUPAC consistency with aDNA deamination leniency: under --ancient, G
    also matches A (R) and C also matches T (Y) (src/ccheck.cc:178-183)."""
    if adna:
        x = {"G": "R", "C": "Y", "g": "r", "c": "y"}.get(x, x)
    return x == "-" or y == "-" or compatible(x, y)


class AlnIndex:
    """The global alignment ``(aln_con, aln_ass)`` indexed once, so that a
    read's walk and lift start at its own span instead of at column 0, as
    src/ccheck.cc:166-176 does for every read.

    Over the ``n = min(len(aln_con), len(aln_ass))`` columns that both
    strings have (the C walks' and ``zip``'s reach):

    * ``first[k]``: the first column with ``k`` assembly bases (non-``-``
      characters of ``aln_ass``) before it, for ``k`` up to ``total``;
    * ``con_before[i]``: the contaminant bases in columns ``[0, i)``, which
      index ``con_bases``, ``aln_con`` without its gaps;
    * ``weak[i]``: ``is_weakly_diagnostic`` of column ``i``."""

    def __init__(self, aln_con: str, aln_ass: str):
        n = min(len(aln_con), len(aln_ass))
        gap = ord("-")
        ass = np.frombuffer(aln_ass[:n].encode("utf-32-le"), np.uint32) != gap
        con = np.frombuffer(aln_con[:n].encode("utf-32-le"), np.uint32) != gap
        self.n = n
        self.first = [0, *(np.flatnonzero(ass) + 1).tolist()]
        self.total = len(self.first) - 1
        self.con_before = [0, *np.cumsum(con).tolist()]
        self.con_bases = aln_con[:n].replace("-", "")
        self.weak = [is_weakly_diagnostic(a, b) for a, b in zip(aln_con, aln_ass)]

    def walk(self, k: int) -> tuple[int, int]:
        """Where the walk from column 0 towards assembly position ``k``
        stops: (column, assembly bases before it)."""
        if 0 <= k <= self.total:
            return self.first[k], k
        return self.n, self.total

    def lift(self, s: int, e: int) -> str:
        """Contaminant bases covering assembly range [s, e)
        (src/ccheck.cc:166-176): those of the columns whose assembly
        position lies in [s, e)."""
        lo = self.walk(max(s, 0))[0]
        hi = self.walk(max(e, 0))[0]
        return self.con_bases[self.con_before[lo] : self.con_before[hi]]


def mk_dp_list(aln1: str, aln2: str, aln: AlnIndex, span_from: int,
               span_to: int) -> dict[int, Dp]:
    """Diagnostic positions keyed by assembly coordinate
    (src/ccheck.cc:132-154); ``aln`` indexes ``(aln1, aln2)``."""
    out: dict[int, Dp] = {}
    i, index = aln.walk(span_from)
    while index != span_to and i < aln.n:
        if aln.weak[i]:
            d = out.setdefault(index, Dp())
            d.consensus = aln1[i]
            d.assembly = aln2[i]
            d.strength = STRONG if is_strongly_diagnostic(aln1[i], aln2[i]) else WEAK
        if aln2[i] != "-":
            index += 1
        i += 1
    return out


def overlapped_positions(keys: list[int], s: AlnSeq) -> tuple[int, int]:
    """lower_bound(start), lower_bound(end+1) over the sorted key list."""
    return bisect_left(keys, s.start), bisect_left(keys, s.end + 1)


def sanity_check_sequence(s: str) -> bool:
    return all(c.upper() in "ACGTBDHVMKYRSWUN" for c in s)


def fixup_name(s: AlnSeq) -> None:
    """Strip the _f/_b suffixes added for circular splits
    (src/ccheck.cc:240-248)."""
    q = s.id
    if len(q) > 3 and q[-1] in "bf" and q[-2] == "_":
        if q[-3] == ",":
            s.id = q[:-3]
        else:
            s.id = q[:-2]


def merge_whatsit(a: Whatsit, b: Whatsit) -> Whatsit:
    if a == b:
        return a
    if a == Whatsit.unknown:
        return b
    if b == Whatsit.unknown:
        return a
    if a == Whatsit.nonsense or b == Whatsit.nonsense:
        return Whatsit.nonsense
    return Whatsit.conflict


def update_class(klass: Whatsit, votes: int, maybe_clean: bool, maybe_dirt: bool):
    if maybe_clean and not maybe_dirt and klass == Whatsit.unknown:
        klass = Whatsit.clean
    if maybe_clean and not maybe_dirt and klass == Whatsit.dirt:
        klass = Whatsit.conflict
    if not maybe_clean and maybe_dirt and klass == Whatsit.unknown:
        klass = Whatsit.dirt
    if not maybe_clean and maybe_dirt and klass == Whatsit.clean:
        klass = Whatsit.conflict
    if not maybe_clean and not maybe_dirt:
        klass = Whatsit.nonsense
    if maybe_clean != maybe_dirt:
        votes += 1
    return klass, votes


def _ch(s: str, i: int) -> str:
    """C-string style indexing: '\\0' past the end."""
    return s[i] if 0 <= i < len(s) else "\0"


@dataclass
class CachedPwaln:
    start: int = 0
    ref_seq: str = ""
    frag_seq: str = ""


def _python_realign_one(submat, ref_for_mia: str, the_read: str, lifted_len: int) -> CachedPwaln:
    """Exact per-read DP of read vs lifted window (src/ccheck.cc:571-603)."""
    frag = init_alignment(
        max(lifted_len, len(the_read)), max(lifted_len, len(the_read)), False, False
    )
    frag.submat = submat
    set_seq1(frag, ref_for_mia)
    set_seq2(frag, the_read)
    frag.sg5 = True
    frag.sg3 = True
    dyn_prog(frag)
    max_sg_score(frag)
    find_align_begin(frag)
    rs, fs_ = populate_pwaln_to_begin(frag)
    return CachedPwaln(start=frag.abc, ref_seq=rs, frag_seq=fs_)


def _solve_device(bh, reads, wlo, whi, lens, submat, big_ref: str, device) -> dict:
    """Score every read whose window fits the device window on the port's
    scorer, in chunks of its batch, and rebuild the winners' tracebacks on
    the host; returns {read index: CachedPwaln} for the reads finished."""
    global device_entries
    ws = np.maximum(wlo - 2, 0)
    dev = [j for j in range(len(reads))
           if whi[j] - ws[j] <= WIN_W and lens[j] <= L_MAX and lens[j] > 0]
    solved: dict[int, CachedPwaln] = {}
    if not dev:
        return solved
    from .torch_engine import Pass1Scorer

    codes = encode_seq(big_ref)
    scorer = Pass1Scorer(codes, codes, len(big_ref), submat, device=device)
    cap = bh.TRACE_CAP
    for c0 in range(0, len(dev), scorer.E):
        chunk = dev[c0 : c0 + scorer.E]
        m = len(chunk)
        a2, o2, l2 = bh.pack_reads([reads[j] for j in chunk])
        s2c = pack_s2c(a2, o2[:-1], l2)
        ivl = np.zeros((m, MAX_INTERVALS, 2), np.int32)
        ivl[:, 0, 0] = wlo[chunk] - ws[chunk]
        ivl[:, 0, 1] = whi[chunk] - ws[chunk]
        h = scorer.dispatch_entries(
            np.zeros(m, np.int8), ws[chunk], ivl, s2c, l2, np.zeros(m, np.int8),
        )
        best, aecl = scorer.collect_entries(h)
        device_entries += m
        aec = (aecl + ws[chunk]).astype(np.int32)
        ivg = np.zeros((m, 1, 2), np.int32)
        ivg[:, 0, 0] = wlo[chunk]
        ivg[:, 0, 1] = whi[chunk]
        meta, ra, fa = bh.finish(
            a2, o2[:-1], l2, np.zeros(m, np.uint8), np.zeros(m, np.uint8),
            best.astype(np.int32), aec, ivg,
        )
        for t, j in enumerate(chunk):
            n = int(meta[t, 3])
            if n < 0:
                continue
            solved[j] = CachedPwaln(
                start=int(meta[t, 1]) - int(wlo[j]),
                ref_seq=ra[t * cap : t * cap + n].decode("latin-1"),
                frag_seq=fa[t * cap : t * cap + n].decode("latin-1"),
            )
    return solved


def _realign_all(maln, index: AlnIndex, submat, engine: str = "torch",
                 device=None) -> tuple[list[str], list[CachedPwaln]]:
    """Pass-1 read re-alignments to the lifted contaminant windows
    (src/ccheck.cc:550-603), batched; returns each read's window and its
    re-alignment.

    "native": all windows concatenate into one pseudo-reference and solve in
    threaded FFI calls (mia_rei_solve fills exactly the sliced-window DP the
    per-read path runs).  "torch": windows that fit the device window score
    on ``device`` first, with the margin-verified native traceback
    (mia_p1_finish); the rest go the native way.  "numpy": the exact
    per-read path.  All three are byte-identical."""
    global host_entries
    jobs: list[tuple[str, str, str]] = []
    for s in maln.aln_seqs:
        parts: list[str] = []
        for i, nt in enumerate(s.seq):
            if nt != "-":
                parts.append(nt)
            ins = s.ins.get(i)
            if ins:
                parts.append(ins)
        the_read = "".join(parts)
        lifted = index.lift(s.start, s.end + 2)
        ref_for_mia = "".join(
            c.upper() if c.upper() in "ACGT" else "N" for c in lifted
        )
        jobs.append((the_read, lifted, ref_for_mia))

    cached = [CachedPwaln() for _ in jobs]
    live = [i for i, (r, _, rm) in enumerate(jobs) if r and rm]
    if engine in ("native", "torch") and live:
        big_ref = "".join(jobs[i][2] for i in live)
        offs = np.zeros(len(live) + 1, np.int64)
        np.cumsum(
            np.fromiter((len(jobs[i][2]) for i in live), np.int64, len(live)),
            out=offs[1:],
        )
        bh = BatchHost.create(big_ref, big_ref, len(big_ref), submat, None, -1, False, 0, 0)
        if bh is None and engine == "torch":
            raise native_unavailable()
        if bh is not None:
            reads = [jobs[i][0] for i in live]
            _, _, lens = bh.pack_reads(reads)
            wlo = offs[:-1].astype(np.int32)
            whi = offs[1:].astype(np.int32)
            solved: dict[int, CachedPwaln] = {}
            if engine == "torch":
                solved = _solve_device(bh, reads, wlo, whi, lens, submat, big_ref, device)

            rest = [j for j in range(len(live)) if j not in solved and lens[j] > 0]
            if engine == "torch":
                host_entries += len(rest)
            CHUNK = 8192
            cap = bh.TRACE_CAP
            for c0 in range(0, len(rest), CHUNK):
                chunk = rest[c0 : c0 + CHUNK]
                a2, o2, l2 = bh.pack_reads([reads[j] for j in chunk])
                meta, ra, fa = bh.solve_rei(
                    a2, o2[:-1], l2,
                    np.zeros(len(chunk), np.uint8),
                    wlo[chunk], whi[chunk],
                )
                for t, j in enumerate(chunk):
                    if meta[t, 0] != STATUS_OK:
                        continue  # per-read python path below
                    n = int(meta[t, 4])
                    solved[j] = CachedPwaln(
                        start=int(meta[t, 2]) - int(wlo[j]),
                        ref_seq=ra[t * cap : t * cap + n].decode("latin-1"),
                        frag_seq=fa[t * cap : t * cap + n].decode("latin-1"),
                    )
            bh.close()
            for j, i in enumerate(live):
                if j in solved:
                    cached[i] = solved[j]

    for i, (the_read, lifted, ref_for_mia) in enumerate(jobs):
        if cached[i].ref_seq or not (ref_for_mia and the_read):
            continue
        cached[i] = _python_realign_one(submat, ref_for_mia, the_read, len(lifted))
    return [lifted for _, lifted, _ in jobs], cached


def print_results(summary: list[int], mktable: bool, out) -> None:
    """Wilson 95% CI contamination estimate (src/ccheck.cc:329-367)."""
    z = 1.96
    k = float(summary[Whatsit.dirt])
    n = k + summary[Whatsit.clean]
    lb = ml = ub = 0.0
    nn = summary[Whatsit.dirt] + summary[Whatsit.clean]
    if n:
        p_ = k / n
        c = p_ + 0.5 * z * z / n
        w = z * math.sqrt(p_ * (1 - p_) / n + 0.25 * z * z / (n * n))
        d = 1 + z * z / n
        lb = 100.0 * (c - w) / d
        ml = 100.0 * p_
        ub = 100.0 * (c + w) / d
    labellen = max(len(LABELS[k_]) for k_ in range(MAXWHATSITS))
    lb = max(lb, 0.0)
    ub = min(ub, 100.0)
    for klass in range(MAXWHATSITS):
        if mktable:
            out.write(f"{summary[klass]}\t")
        else:
            out.write(f"  {LABELS[klass]:>{labellen}} fragments: {summary[klass]}")
            if klass == Whatsit.dirt and nn:
                out.write(f" ({lb:.1f} .. {ml:.1f} .. {ub:.1f}%)")
            out.write("\n")
    if mktable:
        if nn:
            out.write(f"{lb:.1f}\t{ml:.1f}\t{ub:.1f}\t")
        else:
            out.write("N/A\tN/A\tN/A\t")
    else:
        out.write("\n")


def check_contamination(
    maln: MapAlignment,
    hum_ref_seq: str,
    *,
    adna: bool = False,
    transversions: bool = False,
    min_diag_posns: int = 1,
    span_from: int = 0,
    span_to: int = 2**31 - 1,
    maxd: int = 0,
    mktable: bool = False,
    really: bool = False,
    verbose: int = 0,
    out=None,
    infile: str = "",
    engine: str = "torch",
    device=None,
) -> int:
    """Run the two-pass contamination analysis on one maln; returns 0 on
    success, 1 on the safety stop / alignment failure.  Under ``engine ==
    "torch"`` the Myers alignment and the read realignment run on ``device``
    (default: ``torchcfg.select_device``).  Under
    :mod:`mia_tpu_torch.utils.profiling` the two stages time as
    ``ccheck.myers`` and ``ccheck.realign``."""
    out = out or sys.stdout
    err = sys.stderr
    submat = maln.fpsm

    if not maxd:
        maxd = max(len(hum_ref_seq), len(maln.ref.seq)) // 10
    with profiling.phase("ccheck.myers"):
        if engine == "torch":
            from ..ops.myers_torch import myers_diff_torch

            d, aln_con, aln_ass = myers_diff_torch(
                hum_ref_seq, Mode.GLOBAL, maln.ref.seq, maxd, device=device
            )
        else:
            d, aln_con, aln_ass = myers_diff(
                hum_ref_seq, Mode.GLOBAL, maln.ref.seq, maxd
            )
    if d == UINT_MAX:
        err.write(
            f"\n *** Could not align references with up to {maxd} mismatches.\n"
            " *** This is usually a sign of trouble, but\n"
            " *** IF AND ONLY IF YOU KNOW WHAT YOU ARE DOING, you can\n"
            f" *** try the -d N option with N > {maxd}.\n\n"
        )
        return 1
    if mktable:
        out.write(f"{d}\t")
    else:
        out.write(f"  {d} alignment distance between reference and assembly.\n")

    index = AlnIndex(aln_con, aln_ass)
    dps = mk_dp_list(aln_con, aln_ass, index, span_from, span_to)
    if mktable:
        out.write(f"{len(dps)}\t")
    else:
        out.write(
            f"  {len(dps)} total differences between reference and assembly.\n"
        )

    num_strong = sum(1 for v in dps.values() if v.strength > WEAK)
    if mktable:
        out.write(f"{len(dps)}\t")
    else:
        out.write(f"  {len(dps)} diagnostic positions")
        if span_from != 0 or span_to != 2**31 - 1:
            out.write(f" in range [{span_from},{span_to})")
        out.write(f", {num_strong} of which are strongly diagnostic.\n")

    if num_strong < 40 and not really:
        err.write(
            f"\n *** Low number ({num_strong}) of diagnostic positions found.\n"
            " *** I will stop now for your own safety.\n"
            " *** If you are sure you want to shoot yourself\n"
            " *** in the foot, read the man page to learn\n"
            " *** how to lift this restriction.\n\n"
        )
        return 1

    # ---- pass 1: find actually diagnostic positions ----
    # all read-vs-lifted-window re-alignments run batched up front (native
    # threads / device scoring per `engine`); the loop below only walks them,
    # each read from its own span of the indexed alignment
    weak = index.weak
    with profiling.phase("ccheck.realign"):
        windows, cached = _realign_all(maln, index, submat, engine, device)
    for s, pwaln, lifted in zip(maln.aln_seqs, cached, windows):
        fixup_name(s)
        p, ass_pos = index.walk(s.start)  # the global alignment at this read's span
        in_ref = lifted[: pwaln.start] + pwaln.ref_seq
        ir = 0  # index into in_ref
        ifr = 0  # index into pwaln.frag_seq
        ia = 0  # offset into assembly bases from s.start
        ifa = 0  # index into s.seq

        while (
            ass_pos != s.end + 1
            and _ch(aln_con, p) != "\0"
            and _ch(aln_ass, p) != "\0"
            and ir < len(in_ref)
            and _ch(maln.ref.seq, s.start + ia) != "\0"
            and _ch(s.seq, ifa) != "\0"
            and _ch(pwaln.frag_seq, ifr) != "\0"
        ):
            if weak[p]:
                dpv = dps.get(ass_pos)
                if dpv is None:
                    err.write(f"diagnostic site not found: {ass_pos}\n")
                else:
                    if _ch(pwaln.frag_seq, ifr) == _ch(s.seq, ifa):
                        maybe_clean = consistent(adna, dpv.assembly, _ch(s.seq, ifa))
                        maybe_dirt = consistent(
                            adna, dpv.consensus, _ch(pwaln.frag_seq, ifr)
                        )
                        if not maybe_clean and maybe_dirt and dpv.strength == WEAK:
                            dpv.contaminant = _ch(pwaln.frag_seq, ifr)
                            dpv.strength = EFFECTIVE
            if _ch(aln_con, p) != "-":
                while True:
                    ir += 1
                    ifr += 1
                    if _ch(in_ref, ir) != "-":
                        break
            if _ch(aln_ass, p) != "-":
                ass_pos += 1
                while True:
                    ia += 1
                    ifa += 1
                    if _ch(maln.ref.seq, s.start + ia) != "-":
                        break
            p += 1

    # drop surviving weak positions
    dps = {k: v for k, v in dps.items() if v.strength != WEAK}

    t = sum(
        1 for v in dps.values() if is_transversion(v.consensus, v.assembly)
    )
    if mktable:
        out.write(f"{t}\t{num_strong}\t")
    else:
        out.write(f"  {len(dps)} effectively diagnostic positions")
        if span_from != 0 or span_to != 2**31 - 1:
            out.write(f" in range [{span_from},{span_to})")
        out.write(f", {t} of which are transversions.\n\n")

    keys = sorted(dps.keys())

    # ---- pass 2: classify fragments ----
    summary = [0] * MAXWHATSITS
    summary2 = [0] * MAXWHATSITS
    bfrags: dict[str, tuple[Whatsit, int]] = {}
    bfrags2: dict[str, tuple[Whatsit, int]] = {}

    for s, cpw in zip(maln.aln_seqs, cached):
        klass = Whatsit.unknown
        klass2 = Whatsit.unknown
        votes = 0
        votes2 = 0

        lo, hi = overlapped_positions(keys, s)
        if hi - lo >= min_diag_posns:
            p, ass_pos = index.walk(s.start)
            lifted = index.lift(s.start, s.end + 1)
            in_ref = lifted[: cpw.start] + cpw.ref_seq
            ir = 0
            ifr = 0
            ia = 0
            ifa = 0

            while (
                ass_pos != s.end + 1
                and _ch(aln_con, p) != "\0"
                and _ch(aln_ass, p) != "\0"
                and ir < len(in_ref)
                and _ch(maln.ref.seq, s.start + ia) != "\0"
                and _ch(s.seq, ifa) != "\0"
                and _ch(cpw.frag_seq, ifr) != "\0"
            ):
                if weak[p]:
                    dpv = dps.get(ass_pos)
                    if dpv is not None and _ch(cpw.frag_seq, ifr) == _ch(s.seq, ifa):
                        maybe_clean = consistent(adna, dpv.assembly, _ch(s.seq, ifa))
                        maybe_dirt = consistent(
                            adna, dpv.consensus, _ch(cpw.frag_seq, ifr)
                        )
                        klass2, votes2 = update_class(
                            klass2, votes2, maybe_clean, maybe_dirt and not maybe_clean
                        )
                        if dpv.strength == STRONG:
                            klass, votes = update_class(
                                klass, votes, maybe_clean, maybe_dirt
                            )
                if _ch(aln_con, p) != "-":
                    while True:
                        ir += 1
                        ifr += 1
                        if _ch(in_ref, ir) != "-":
                            break
                if _ch(aln_ass, p) != "-":
                    ass_pos += 1
                    while True:
                        ia += 1
                        ifa += 1
                        if _ch(maln.ref.seq, s.start + ia) != "-":
                            break
                p += 1

        if s.segment == "b":
            bfrags[s.id] = (klass, votes)
            bfrags2[s.id] = (klass2, votes2)
        elif s.segment in ("f", "a"):
            if s.segment == "f":
                i1 = bfrags.get(s.id)
                if i1 is None:
                    err.write(f"{s.id}/f is missing its back.\n")
                else:
                    votes += i1[1]
                    klass = merge_whatsit(klass, i1[0])
                i2 = bfrags2.get(s.id)
                if i2 is None:
                    err.write(f"{s.id}/f is missing its back.\n")
                elif i1 is not None:
                    # reference quirk: the second estimate merges the FIRST
                    # map's entry (src/ccheck.cc:843-852)
                    votes2 += i1[1]
                    klass2 = merge_whatsit(klass2, i1[0])
            summary[klass] += 1
            summary2[klass2] += 1
        else:
            err.write(f"don't know how to handle fragment type {s.segment}\n")

    if not mktable:
        t = sum(1 for v in dps.values() if v.strength == STRONG)
        out.write(f"  strongly diagnostic positions: {t}\n")
    print_results(summary, mktable, out)
    if not mktable:
        out.write(f"  effectively diagnostic positions: {len(dps)}\n")
    else:
        out.write(f"{len(dps)}\t")
    print_results(summary2, mktable, out)
    out.write("\n")
    return 0
