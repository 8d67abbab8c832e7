"""Pass 1's WIDE reads scored by the general-width scorer (the port's
``dp_cuda.dp_last_row``, its plain version on the CPU) against the native
full solve (``BatchHost.solve_pass1``) and against ``mia_tpu``'s
``dp_jax.batch_last_row`` on the same windows.

A WIDE read is one whose k-mer band spans more than the entry window on
either strand (every read without ``-k``).  Each strand with intervals is
scored over its own window (``entries.wide_rows``); the strand pick, the
gate and the score-verified traceback (``BatchHost.finish``) then run as
for a windowed winner.  The sample has reads across the circular origin,
reads made of two distant stretches of the reference, reads that hit one
strand only, a homopolymer read over two distant runs (a last row with
tied maxima) and reads that hit nothing; and runs with and without ``-k``.

Tolerance: exact equality of every score, column and traceback string.
"""
import numpy as np
import pytest
import torch

from mia_tpu.ops import dp_jax
from mia_tpu.ops.pssm import init_flatsubmat
from mia_tpu_torch.constants import FIRST_ROUND_SCORE_CUTOFF
from mia_tpu_torch.core import entries
from mia_tpu_torch.core import torch_engine as te
from mia_tpu_torch.core.assembler import GATED, TRACED, WIDE, plan_batch
from mia_tpu_torch.core.entries import L_MAX, MAX_INTERVALS, WIN_W
from mia_tpu_torch.core.hostbatch import (
    FLAG_WIDE,
    STATUS_GATED,
    STATUS_OK,
    BatchHost,
)
from mia_tpu_torch.ops import dp_cuda, dp_torch
from mia_tpu_torch.utils.encoding import encode_seq, revcom

WRAP = 256


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread a worker, so that several workers on one machine do
    not spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(rng, n):
    """A random reference with the same 70-base homopolymer at two distant
    places."""
    ref = list(rng.choice(list("ACGT"), n))
    for at in (300, n - 500):
        ref[at : at + 70] = "A" * 70
    return "".join(ref)


def _reads(rng, ref):
    n = len(ref)
    up = ref.upper()
    reads = []
    for _ in range(60):  # ordinary reads, some mutated, half reverse complemented
        ln = int(rng.integers(25, 120))
        p = int(rng.integers(0, n - ln))
        s = "".join(c if rng.random() > 0.04 else rng.choice(list("ACGT"))
                    for c in up[p : p + ln])
        reads.append(revcom(s) if rng.random() < 0.5 else s)
    for _ in range(6):  # across the circular origin
        a, b = int(rng.integers(20, 60)), int(rng.integers(20, 60))
        s = up[n - a :] + up[:b]
        reads += [s, revcom(s)]
    for _ in range(6):  # two distant stretches: a band over both
        p, q = int(rng.integers(0, n // 3)), int(rng.integers(2 * n // 3, n - 40))
        s = up[p : p + 30] + up[q : q + 30]
        reads += [s, revcom(s)]
    reads += ["A" * 45, "T" * 45]  # both homopolymers: tied maxima
    reads += ["".join(rng.choice(list("ACGT"), 50)) for _ in range(4)]  # no hits
    return reads


def _setup(seed: int, kmer: int, circular: bool):
    rng = np.random.default_rng(seed)
    ref = _reference(rng, 2000)
    fw, rc = ref, revcom(ref)
    if circular:
        fw, rc = fw + fw[:WRAP], rc + rc[:WRAP]
    len1 = len(fw)
    sm = (init_flatsubmat() + rng.integers(-60, 60, (31, 5, 5))).astype(np.int32)
    bhost = BatchHost.create(fw, rc, len1, sm, None, kmer, False, WIN_W, MAX_INTERVALS)
    assert bhost is not None
    scorer = te.Pass1Scorer(encode_seq(fw), encode_seq(rc), len1, sm, batch=256,
                            device="cpu")
    reads = _reads(rng, ref)
    arena, off, lens = bhost.pack_reads(reads)
    prep = bhost.prepare(arena, off, lens, L_MAX, MAX_INTERVALS)[:6]
    return bhost, scorer, sm, arena, off[:-1], lens, prep


def _scores(scorer, lens, prep):
    """(fb, fa, rb, ra) of the batch from the scorer, the wide reads'
    included."""
    s2c, fw_ws, rc_ws, fw_ivg, rc_ivg, flags = prep
    handle = scorer.dispatch_packed(s2c, lens, fw_ws, rc_ws, fw_ivg, rc_ivg, flags)
    assert scorer.ready(handle)
    return scorer.collect_arrays(handle)


CASES = [(1, 12, True), (2, 12, False), (3, -1, True)]
IDS = ["k12-circular", "k12-linear", "no-k-circular"]


@pytest.mark.parametrize("seed,kmer,circular", CASES, ids=IDS)
def test_wide_scores_match_native_solve_and_jax(seed, kmer, circular):
    """(a) Per strand, the scorer's (best, aec) of every WIDE read equals
    dp_jax.batch_last_row's on the same windows; the winner's strand, score
    and gate equal the native full solve's."""
    bhost, scorer, sm, arena, off, lens, prep = _setup(seed, kmer, circular)
    s2c, fw_ws, rc_ws, fw_ivg, rc_ivg, flags = prep
    sel = entries.wide_scored(flags, lens)
    assert sel.sum() >= (len(lens) if kmer < 0 else 10)
    rows = entries.wide_rows(flags, lens, s2c, fw_ivg, rc_ivg)
    # a strand without intervals has no row
    assert rows.n < 2 * int(sel.sum()) or kmer < 0
    dp_cuda.reset_counts()
    fb, fa, rb, ra = _scores(scorer, lens, prep)
    # the rows whose band fits took the band form, the wider ones the
    # strand form, the rest the full form
    nb, ns = rows.n_band, rows.n_strand
    assert (dp_cuda.last_row_band_plain_calls, dp_cuda.last_row_strand_plain_calls,
            dp_cuda.last_row_plain_calls) == (int(nb > 0), int(ns > 0), int(nb + ns < rows.n))
    assert dp_cuda.last_row_band_launches == dp_cuda.last_row_launches == 0
    assert dp_cuda.last_row_strand_launches == 0
    assert (dp_cuda.last_row_band_rows, dp_cuda.last_row_strand_rows,
            dp_cuda.last_row_rows) == (nb, ns, rows.n - nb - ns)

    # the same windows through mia_tpu's scan
    s1c, mask, rs2c, rlen, depths = entries.wide_inputs(rows, scorer.state.refs.numpy())
    np.testing.assert_array_equal(depths, dp_jax.depths_for(rlen, rs2c.shape[1]))
    last = np.asarray(dp_jax.batch_last_row(s1c, mask, rs2c, rlen, depths, sm))
    jb, ja = (np.asarray(x) for x in dp_jax.batch_best_and_aec(last))
    want = {0: {}, 1: {}}
    for r in range(rows.n):
        want[int(rows.strand[r])][int(rows.read[r])] = (int(jb[r]), int(ja[r]) + int(rows.win_lo[r]))
    for i in np.flatnonzero(sel):
        for strand, (b, a) in ((0, (fb, fa)), (1, (rb, ra))):
            got = (int(b[i]), int(a[i]))
            assert got == want[strand].get(int(i), (entries.NO_BAND_SCORE, 0)), (i, strand)

    # the winner against the native full solve of the same reads
    idx = np.flatnonzero(sel)
    meta, _, _ = bhost.solve_pass1(arena, off[idx], lens[idx], False)
    kind, rc, best, aec = plan_batch(flags, fb, fa, rb, ra, False, sel)
    assert not (kind[idx] == WIDE).any()  # none is left to the native solve
    for j, i in enumerate(idx):
        st, m_rc, m_best, _, m_aec, _ = (int(x) for x in meta[j])
        assert st in (STATUS_OK, STATUS_GATED), (i, st)
        assert (bool(rc[i]), int(best[i])) == (bool(m_rc), m_best), i
        if st == STATUS_GATED:
            assert kind[i] == GATED and best[i] < FIRST_ROUND_SCORE_CUTOFF, i
        else:
            assert kind[i] == TRACED and int(aec[i]) == m_aec, i
    assert (kind[idx] == TRACED).any() and (rb[idx] != fb[idx]).any()


@pytest.mark.parametrize("seed,kmer,circular", CASES, ids=IDS)
def test_wide_tracebacks_match_native_solve(seed, kmer, circular):
    """(b) A WIDE winner's score-verified traceback (BatchHost.finish with
    its strand's global intervals, from the card's best and aec) gives the
    native full solve's strand, score, start, end and strings; a gated one
    its strand and score."""
    bhost, scorer, _, arena, off, lens, prep = _setup(seed, kmer, circular)
    s2c, fw_ws, rc_ws, fw_ivg, rc_ivg, flags = prep
    sel = entries.wide_scored(flags, lens)
    fb, fa, rb, ra = _scores(scorer, lens, prep)
    kind, rc, best, aec = plan_batch(flags, fb, fa, rb, ra, False, sel)
    idx = np.flatnonzero(sel)
    cap = bhost.TRACE_CAP
    meta, ref_a, frag_a = bhost.solve_pass1(arena, off[idx], lens[idx], False)
    win = idx[kind[idx] == TRACED]
    strand = rc[win].astype(np.uint8)
    ivg = np.where(strand[:, None, None] == 1, rc_ivg[win], fw_ivg[win])
    fmeta, fref, ffrag = bhost.finish(arena, off[win], lens[win], strand,
                                      np.zeros(len(win), np.uint8),
                                      best[win].astype(np.int32), aec[win].astype(np.int32),
                                      ivg, cap=cap)
    row = {int(i): j for j, i in enumerate(win)}
    checked = 0
    for j, i in enumerate(idx):
        st, m_rc, m_best, m_abc, m_aec, m_len = (int(x) for x in meta[j])
        got_gate = "gated" if kind[i] == GATED else "aligned"
        assert got_gate == ("gated" if st == STATUS_GATED else "aligned"), i
        assert (int(rc[i]), int(best[i])) == (m_rc, m_best), i
        if st != STATUS_OK:
            continue
        k = row[int(i)]
        assert tuple(int(x) for x in fmeta[k]) == (m_best, m_abc, m_aec, m_len), i
        assert fref[k * cap : k * cap + m_len] == ref_a[j * cap : j * cap + m_len], i
        assert ffrag[k * cap : k * cap + m_len] == frag_a[j * cap : j * cap + m_len], i
        checked += 1
    assert checked >= 5


@pytest.mark.parametrize("seed,kmer,circular", CASES[:2], ids=IDS[:2])
def test_wide_device_inputs_equal_numpy_helper(seed, kmer, circular):
    """The windows and masks the scorer builds on its device from a batch's
    rows equal ``entries.wide_inputs``'s dense arrays."""
    _, scorer, _, _, _, lens, prep = _setup(seed, kmer, circular)
    s2c, _, _, fw_ivg, rc_ivg, flags = prep
    rows = entries.wide_rows(flags, lens, s2c, fw_ivg, rc_ivg)
    s1c, mask = dp_torch.wide_device_inputs(
        scorer.state.refs, rows.width, torch.from_numpy(rows.strand),
        torch.from_numpy(rows.win_lo), torch.from_numpy(rows.ivl))
    want = entries.wide_inputs(rows, scorer.state.refs.numpy())
    np.testing.assert_array_equal(s1c.numpy(), want[0])
    np.testing.assert_array_equal(mask.numpy(), want[1])
    assert (rows.width >= (rows.ivl[:, :, 1].max(1))).all() and rows.width > WIN_W
    assert ((flags[rows.read] & FLAG_WIDE) != 0).all()


def test_first_maximum_on_tied_rows():
    """The earliest column of a tied maximum, as the native solve's strict
    '>' scan takes it: on an all-tied row, on plateaus and on rows of HIM."""
    rng = np.random.default_rng(7)
    rows = rng.integers(-50, 50, (6, 300)).astype(np.int32)
    rows[0] = 17
    rows[1, 40:200] = 99
    rows[2] = entries.NO_BAND_SCORE
    rows[3, [5, 250]] = 1000
    gb, ga = dp_torch.batch_best_and_aec(torch.from_numpy(rows))
    jb, ja = dp_jax.batch_best_and_aec(rows)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ga.numpy()[:4], [0, 40, 0, 5])
