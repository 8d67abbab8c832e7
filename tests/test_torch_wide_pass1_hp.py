"""Pass 1's WIDE reads under ``-h``, scored by the full-width ``-h`` scorer
(the port's ``dp_cuda.dp_last_row_hp``, its plain version
``dp_torch.last_row_hp_plain`` on the CPU) against ``mia_tpu``'s
``dp_jax.batch_last_row_hp`` on the same windows and against the native
full solve (``BatchHost.solve_pass1`` with the homopolymer recurrence).

(a) The plain scorer on ``testing.hp_wide_inputs``' edge rows (read runs of
1, 2 and 31 bases, a window that starts inside a reference run, a reference
run at columns 0-1, tied maxima, one-column bands, rows narrower than the
batch's window and windows past the strand state) at W = 2,300 and at a
whole human-mt strand's width.  (b) Whole pass-1 batches of ``-h`` samples
(circular and linear ``-k 12``, and no ``-k``) through
``Pass1Scorer.dispatch_packed``: reads across the origin, reads of two
distant stretches, one-strand reads, reads that hit nothing, reads with
runs grown and shrunk, and reads with a run of 32+ bases, which stay
``HOST``.  (c) The width rule: a read whose strand window passes
``entries.HP_WIDE_COLS`` stays with the native solve, and a whole run
counts it.

Tolerance: exact equality of every score, column and traceback string.
"""
import os

import numpy as np
import pytest
import torch

from mia_tpu.ops import dp_jax
from mia_tpu.ops.pssm import init_flatsubmat
from mia_tpu_torch import testing as T
from mia_tpu_torch.constants import FIRST_ROUND_SCORE_CUTOFF
from mia_tpu_torch.core import entries
from mia_tpu_torch.core import torch_engine as te
from mia_tpu_torch.core.assembler import GATED, HOST, TRACED, WIDE, plan_batch
from mia_tpu_torch.core.entries import HPW_ROUTE, L_MAX, MAX_INTERVALS, WIN_W
from mia_tpu_torch.core.hostbatch import (
    FLAG_HOST_ONLY,
    STATUS_GATED,
    STATUS_OK,
    BatchHost,
)
from mia_tpu_torch.ops import dp_cuda
from mia_tpu_torch.utils.encoding import encode_seq, revcom

from .test_torch_golden import _norm, profile_counters, run_torch_mia

WRAP = 256


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread a worker, so that several workers on one machine do
    not spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense(d: dict) -> dict:
    """``dp_jax.batch_last_row_hp``'s dense arguments for the rows of ``d``
    (``testing.hp_wide_inputs``' keys), made in numpy as
    ``jax_engine._entries_core_hp`` gathers a window: codes, chars and run
    starts of each row's window of its strand (past the state: 4, 0, 0),
    the band from the intervals, the per-row PSSM scores."""
    W = d["width"]
    WTOT = d["refs"].shape[1]
    g = d["win_lo"].astype(np.int64)[:, None] + np.arange(W)[None, :]
    inside = g < WTOT
    s = d["strand"].astype(np.int64)[:, None]
    at = np.minimum(g, WTOT - 1)

    def win(a, pad):
        return np.where(inside, a[s, at], pad).astype(np.int32)

    iv = d["ivl"].astype(np.int64)
    cols = np.arange(W)[None, None, :]
    mask = ((cols >= iv[:, :, 0:1]) & (cols < iv[:, :, 1:2])).any(1)
    s2chr = d["s2chr"].astype(np.int32)
    s2c = d["b2i"][s2chr].astype(np.int64)
    depths = T.depths_numpy(d["lengths"], s2chr.shape[1])
    row_sm = np.transpose(d["submat"], (0, 2, 1))[depths, s2c]
    return dict(s1c=win(d["refs"], 4), s1chr=win(d["refchr"], 0), mask=mask,
                row_sm=row_sm.astype(np.int32), lengths=d["lengths"], s2chr=s2chr,
                hpcs_w=win(d["hpcs"], 0), ws=d["win_lo"], pengop=d["pengop"])


@pytest.mark.parametrize("W,L,seed", [(2300, 48, 0), (2300, 40, 1), (16875, 40, 2)],
                         ids=["W2300-a", "W2300-b", "W16875"])
def test_plain_hp_scorer_equals_jax(W, L, seed):
    """(a) (best, first column of the best) of every row equal
    dp_jax.batch_last_row_hp's last row's, and the edge rows are what they
    claim to be."""
    d = T.hp_wide_inputs(W, L, seed)
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row_hp(*(torch.from_numpy(d[k]) for k in T.HP_WIDE_KEYS), W)
    assert (dp_cuda.last_row_hp_plain_calls, dp_cuda.last_row_hp_launches) == (1, 0)
    last = np.asarray(dp_jax.batch_last_row_hp(**_dense(d)))
    jb, ja = (np.asarray(x) for x in dp_jax.batch_best_and_aec(last))
    np.testing.assert_array_equal(got.numpy(), np.stack([jb, ja]))

    # the edges: a reference run at columns 0-1 under row 0, row 1's window
    # starting inside a run, read runs of 1, 2 and 31, an all-A read tied
    # along the all-A stretch, one-column bands, rows past the state
    assert d["hpcs"][0, 1] == 0 and d["hpcs"][0, 2] == 2 and d["win_lo"][0] == 0
    assert d["hpcs"][0, d["win_lo"][1]] < d["win_lo"][1]
    runs = np.diff(np.flatnonzero(np.diff(np.r_[-1, d["s2chr"][5].astype(int), -1]) != 0))
    assert {1, 2, 31} <= set(runs.tolist())
    tied = np.flatnonzero(last[6] == last[6].max())
    assert len(tied) > 1 and ja[6] == tied[0]
    assert (d["ivl"][2, :, 1] - d["ivl"][2, :, 0] == 1).all()
    assert (d["win_lo"][2:4] + W > d["refs"].shape[1]).all()
    assert (jb > entries.NO_BAND_SCORE).sum() >= len(jb) - 2


def test_plain_hp_scorer_rejects_wider_rows_and_bad_inputs():
    d = T.hp_wide_inputs(400, 40, 3)
    args = [torch.from_numpy(d[k]) for k in T.HP_WIDE_KEYS]
    with pytest.raises(ValueError, match="width"):
        dp_cuda.dp_last_row_hp(*args, entries.HP_WIDE_COLS + 1)
    bad = list(args)
    bad[9] = bad[9].to(torch.int32)  # codes where chars belong
    with pytest.raises(TypeError, match="s2chr"):
        dp_cuda.dp_last_row_hp(*bad, 400)
    bad = list(args)
    bad[2] = bad[2][:, :-1].contiguous()
    with pytest.raises(ValueError, match="hpcs"):
        dp_cuda.dp_last_row_hp(*bad, 400)


def _reads(rng, ref):
    n = len(ref)
    up = ref.upper()
    reads = []
    for _ in range(50):  # cut from the reference, runs grown and shrunk, half rc
        ln = int(rng.integers(25, 120))
        p = int(rng.integers(0, n - 2 * ln))
        s = T._mutate_runs(rng, up[p : p + 2 * ln])[:ln].replace("N", "A")
        reads.append(revcom(s) if rng.random() < 0.5 else s)
    for _ in range(5):  # across the circular origin
        a, b = int(rng.integers(20, 60)), int(rng.integers(20, 60))
        s = up[n - a :] + up[:b]
        reads += [s, revcom(s)]
    for _ in range(5):  # two distant stretches: a band over both
        p, q = int(rng.integers(0, n // 3)), int(rng.integers(2 * n // 3, n - 40))
        s = up[p : p + 30] + up[q : q + 30]
        reads += [s, revcom(s)]
    reads += ["A" * 45, "T" * 45]  # runs of 32+: the host path
    s = up[500:540] + "G" * 34 + up[540:570]
    reads += [s, revcom(s)]
    reads += ["".join(rng.choice(list("ACGT"), 50)) for _ in range(4)]  # no hits
    return reads


def _setup(seed: int, kmer: int, circular: bool):
    rng = np.random.default_rng(seed)
    ref = list(T._runs_string(rng, 2000))
    for at in (300, 1500):
        ref[at : at + 70] = "A" * 70
    ref = "".join(ref)
    fw, rc = ref, revcom(ref)
    if circular:
        fw, rc = fw + fw[:WRAP], rc + rc[:WRAP]
    len1 = len(fw)
    sm = (init_flatsubmat() + rng.integers(-60, 60, (31, 5, 5))).astype(np.int32)
    bhost = BatchHost.create(fw, rc, len1, sm, None, kmer, False, WIN_W, MAX_INTERVALS,
                             hp=True)
    assert bhost is not None
    scorer = te.Pass1Scorer(encode_seq(fw), encode_seq(rc), len1, sm, batch=256,
                            device="cpu", hp_seqs=(fw, rc))
    reads = _reads(rng, ref)
    arena, off, lens = bhost.pack_reads(reads)
    s2c, fw_ws, rc_ws, fw_ivg, rc_ivg, flags = bhost.prepare(arena, off, lens, L_MAX,
                                                              MAX_INTERVALS)[:6]
    # as pass 1 prepares a batch under -h (assembler._prepare_dispatch)
    flags[entries.longest_runs(arena, off, lens) >= HPW_ROUTE] |= FLAG_HOST_ONLY
    s2chr = entries.pack_chars(arena, off[:-1], lens)
    prep = (s2chr, fw_ws, rc_ws, fw_ivg, rc_ivg, flags)
    return bhost, scorer, sm, arena, off[:-1], lens, prep


CASES = [(1, 12, True), (2, 12, False), (3, -1, True)]
IDS = ["k12-circular", "k12-linear", "no-k-circular"]


@pytest.mark.parametrize("seed,kmer,circular", CASES, ids=IDS)
def test_wide_hp_scores_match_native_solve_and_jax(seed, kmer, circular):
    """(b) Per strand, the scorer's (best, aec) of every -h WIDE read equals
    dp_jax.batch_last_row_hp's on the same windows; the winner's strand,
    score, end column and gate equal the native full solve's under -h; the
    reads with a run of 32+ stay HOST."""
    bhost, scorer, sm, arena, off, lens, prep = _setup(seed, kmer, circular)
    s2chr, fw_ws, rc_ws, fw_ivg, rc_ivg, flags = prep
    widths = entries.window_widths(fw_ivg, rc_ivg)
    sel = entries.wide_scored(flags, lens, widths)
    host = (flags & FLAG_HOST_ONLY) != 0
    assert host.sum() >= 4 and not (sel & host).any()
    # without -k every read is WIDE
    assert (sel == ~host).all() if kmer < 0 else sel.sum() >= 10
    rows = entries.wide_rows(flags, lens, s2chr, fw_ivg, rc_ivg, hp=True)
    assert rows.s2c.dtype == np.uint8
    # a strand without intervals has no row
    assert rows.n < 2 * int(sel.sum()) or kmer < 0
    dp_cuda.reset_counts()
    handle = scorer.dispatch_packed(*prep[:1], lens, *prep[1:])
    assert scorer.ready(handle)
    fb, fa, rb, ra = scorer.collect_arrays(handle)
    # the rows whose band fits by the band form, the rest (whole strands
    # here) by the strand form, none by the full form
    assert rows.n_band + rows.n_strand == rows.n
    assert (dp_cuda.last_row_hp_band_plain_calls, dp_cuda.last_row_hp_strand_plain_calls,
            dp_cuda.last_row_hp_plain_calls) == (int(rows.n_band > 0), int(rows.n_strand > 0), 0)
    assert (dp_cuda.last_row_hp_band_launches, dp_cuda.last_row_hp_strand_launches,
            dp_cuda.last_row_hp_launches) == (0, 0, 0)
    assert dp_cuda.last_row_plain_calls == dp_cuda.last_row_launches == 0

    # the same windows through mia_tpu's scan
    st = scorer.state
    d = dict(refs=st.refs.numpy(), refchr=st.refchr.numpy(), hpcs=st.hpcs.numpy(),
             submat=sm, pengop=st.pengop.numpy(), b2i=st.b2i.numpy(), strand=rows.strand,
             win_lo=rows.win_lo, ivl=rows.ivl, s2chr=rows.s2c, lengths=rows.lengths,
             width=rows.width)
    last = np.asarray(dp_jax.batch_last_row_hp(**_dense(d)))
    jb, ja = (np.asarray(x) for x in dp_jax.batch_best_and_aec(last))
    want = {0: {}, 1: {}}
    for r in range(rows.n):
        want[int(rows.strand[r])][int(rows.read[r])] = (int(jb[r]),
                                                       int(ja[r]) + int(rows.win_lo[r]))
    for i in np.flatnonzero(sel):
        for strand, (b, a) in ((0, (fb, fa)), (1, (rb, ra))):
            got = (int(b[i]), int(a[i]))
            assert got == want[strand].get(int(i), (entries.NO_BAND_SCORE, 0)), (i, strand)

    # the winner against the native full solve of the same reads under -h
    idx = np.flatnonzero(sel)
    meta, _, _ = bhost.solve_pass1(arena, off[idx], lens[idx], False)
    kind, rc, best, aec = plan_batch(flags, fb, fa, rb, ra, False, sel)
    assert not (kind[idx] == WIDE).any()  # none is left to the native solve
    assert (kind[host] == HOST).all()
    for j, i in enumerate(idx):
        st_, m_rc, m_best, _, m_aec, _ = (int(x) for x in meta[j])
        assert st_ in (STATUS_OK, STATUS_GATED), (i, st_)
        assert (bool(rc[i]), int(best[i])) == (bool(m_rc), m_best), i
        if st_ == STATUS_GATED:
            assert kind[i] == GATED and best[i] < FIRST_ROUND_SCORE_CUTOFF, i
        else:
            assert kind[i] == TRACED and int(aec[i]) == m_aec, i
    assert (kind[idx] == TRACED).any() and (rb[idx] != fb[idx]).any()


@pytest.mark.parametrize("seed,kmer,circular", CASES, ids=IDS)
def test_wide_hp_tracebacks_match_native_solve(seed, kmer, circular):
    """(b) A -h WIDE winner's score-verified traceback (BatchHost.finish
    with the homopolymer recurrence, from the card's best and aec) gives the
    native full solve's strand, score, start, end and strings; a gated one
    its strand and score."""
    bhost, scorer, _, arena, off, lens, prep = _setup(seed, kmer, circular)
    s2chr, fw_ws, rc_ws, fw_ivg, rc_ivg, flags = prep
    sel = entries.wide_scored(flags, lens, entries.window_widths(fw_ivg, rc_ivg))
    fb, fa, rb, ra = scorer.collect_arrays(scorer.dispatch_packed(s2chr, lens, *prep[1:]))
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


def test_width_rule_at_the_limit():
    """(c) A -h WIDE read is taken while both strand windows are at most
    HP_WIDE_COLS columns wide (two columns before the first interval to the
    end of the last), and left to the native solve one column past it;
    without -h the width does not matter."""
    limit = entries.HP_WIDE_COLS
    assert limit == dp_cuda.LAST_ROW_COLS * dp_cuda.LAST_ROW_THREADS == 17408
    n = 5
    fw_ivg = np.zeros((n, MAX_INTERVALS, 2), np.int32)
    rc_ivg = np.zeros_like(fw_ivg)
    fw_ivg[:, 0] = (10, 300)
    fw_ivg[1, 1] = (9000, 8 + limit)        # window [8, 8 + limit): at the limit
    fw_ivg[2, 1] = (9000, 9 + limit)        # one column past it
    rc_ivg[3, 0] = (1, limit + 1)           # window from column 0 (max(1 - 2, 0))
    rc_ivg[4, 0] = (0, limit + 1)
    widths = entries.window_widths(fw_ivg, rc_ivg)
    np.testing.assert_array_equal(widths, [292, limit, limit + 1, limit + 1, limit + 1])
    flags = np.full(n, 4, np.int32)  # FLAG_WIDE
    lens = np.full(n, 50, np.int32)
    np.testing.assert_array_equal(entries.wide_scored(flags, lens, widths),
                                  [True, True, False, False, False])
    assert entries.wide_scored(flags, lens).all()
    s2chr = np.full((n, L_MAX), ord("A"), np.uint8)
    rows = entries.wide_rows(flags, lens, s2chr, fw_ivg, rc_ivg, hp=True)
    np.testing.assert_array_equal(rows.sel, [0, 1])
    assert rows.width == limit
    # scores of 0 fail the gate: the taken reads are decided by them
    kind = plan_batch(flags, *np.zeros((4, n), np.int64), False,
                      entries.wide_scored(flags, lens, widths))[0]
    np.testing.assert_array_equal(kind, [GATED, GATED, WIDE, WIDE, WIDE])


def test_width_rule_routes_a_long_reference_to_the_native_solve(tmp_path):
    """(c) A whole -h run without -k on a reference longer than HP_WIDE_COLS:
    every read's window is the whole strand, so each goes to the native
    solve, counted as pass1.native_solved_wide_reads, the full-width -h
    scorer is never called, and the malns equal --engine native's."""
    rng = np.random.default_rng(9)
    ref = T._runs_string(rng, entries.HP_WIDE_COLS + 200)
    reads = []
    for k in range(12):
        p = int(rng.integers(0, len(ref) - 120))
        s = T._mutate_runs(rng, ref[p : p + 90])[:60]
        reads.append(revcom(s) if k % 2 else s)
    ref_fn, frag_fn = tmp_path / "ref.fna", tmp_path / "reads.fna"
    ref_fn.write_text(">ref\n" + "\n".join(ref[i : i + 70] for i in range(0, len(ref), 70))
                      + "\n")
    frag_fn.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    args = ["-r", str(ref_fn), "-f", str(frag_fn), "-h"]
    (tmp_path / "torch").mkdir()
    (tmp_path / "native").mkdir()
    c = profile_counters(run_torch_mia(args, tmp_path / "torch").stderr)
    run_torch_mia(args, tmp_path / "native", engine="native")
    names = sorted(p for p in os.listdir(tmp_path / "native") if p.startswith("out.maln."))
    assert names and names == sorted(p for p in os.listdir(tmp_path / "torch")
                                     if p.startswith("out.maln."))
    for fn in names:
        assert _norm(tmp_path / "torch" / fn) == _norm(tmp_path / "native" / fn), fn
    assert c["pass1.native_solved_wide_reads"] == len(reads), c
    assert c["pass1.device_scored_wide_reads"] == 0, c
    assert c["dp.last_row_hp_plain_calls"] == c["dp.last_row_hp_launches"] == 0, c
    assert c["dp.last_row_hp_band_plain_calls"] == c["dp.last_row_hp_band_launches"] == 0, c
    assert c["dp.last_row_hp_strand_plain_calls"] == c["dp.last_row_hp_strand_launches"] == 0, c
    assert c["dp.hp_plain_calls"] > 0, c
