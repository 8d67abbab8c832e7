"""The ``-h`` band form of the full-width scorer (``dp_cuda.dp_last_row_hp``'s
first ``n_band`` rows; its plain version ``dp_torch.last_row_hp_band_plain``
on the CPU), which scores a wide row on its band columns only, against
``mia_tpu``'s ``dp_jax.batch_last_row_hp`` over the row's whole window.

(a) The band columns (``entries.band_columns``, ``dp_torch.band_layout``)
against a count over the dense band.  (b) The plain band form on
``testing.hp_band_inputs``' edge rows (band columns of 384, 385, 768, 769,
1,536, 3,072 and 3,073, open columns of 384 and 385, bands at window
columns 0 and 1, an hp_col source in another interval, in a closed gap and
in a row's first warp for a cell of its second, a reference run at a
warp's first column, touching and overlapping intervals, 16 one-column
intervals, gaps of one and two columns, empty intervals, no open column, a
band past the strand state, reads of 1 and 2 bases) and on
``testing.hp_wide_inputs``' rows whose band fits.  (c) The wrapper's two
forms in one call, the band rows ordered by warps, in row order, with their
counters, and its input checks.  (d) The split of the three pass-1 ``-h``
batches of ``test_torch_wide_pass1_hp`` (``entries.wide_rows``: band
classes, then the strand form's rows, none left to the full form) and
their band rows through the wrapper.

Tolerance: exact equality of every (best, column).
"""
import numpy as np
import pytest
import torch

from mia_tpu.ops import dp_jax
from mia_tpu_torch import testing as T
from mia_tpu_torch.core import entries
from mia_tpu_torch.core.entries import BAND_ROW_COLS, HIM
from mia_tpu_torch.ops import dp_cuda, dp_torch

from .test_torch_wide_pass1_hp import CASES, IDS, _dense, _setup


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread a worker, so that several workers on one machine do
    not spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_pairs(d: dict) -> np.ndarray:
    """[2, R] (best, first column of the best) of dp_jax.batch_last_row_hp
    over each row's window of ``d["width"]`` columns."""
    last = np.asarray(dp_jax.batch_last_row_hp(**_dense(d)))
    return np.stack([np.asarray(x) for x in dp_jax.batch_best_and_aec(last)])


def _args(d: dict) -> list:
    return [torch.from_numpy(np.ascontiguousarray(d[k])) for k in T.HP_WIDE_KEYS]


@pytest.mark.parametrize("seed", [0, 1])
def test_band_columns_match_the_dense_band(seed):
    """(a) open and band columns per row, and band_layout's columns: the
    union of the intervals, and the union with the two columns before each
    run, in order."""
    d = T.hp_band_inputs(40, seed)
    ivl = d["ivl"]
    W = d["width"] + 2
    cols = np.arange(W)
    dense = ((cols[None, None, :] >= ivl[:, :, 0:1]) & (cols[None, None, :] < ivl[:, :, 1:2])
             ).any(1)
    near = dense.copy()
    near[:, :-1] |= dense[:, 1:]
    near[:, :-2] |= dense[:, 2:]
    o, c = entries.band_columns(ivl)
    np.testing.assert_array_equal(o, dense.sum(1))
    np.testing.assert_array_equal(c, near.sum(1))
    bc, bopen, bn = (x.numpy() for x in dp_torch.band_layout(torch.from_numpy(ivl)))
    np.testing.assert_array_equal(bn, c)
    for r in range(len(ivl)):
        if c[r] > BAND_ROW_COLS:
            assert not bopen[r].any()
            continue
        np.testing.assert_array_equal(bc[r, : c[r]], np.flatnonzero(near[r]))
        np.testing.assert_array_equal(bopen[r, : c[r]], dense[r, near[r]])
        assert not bopen[r, c[r]:].any() and (np.diff(bc[r]) > 0).all()
    # the edges are what they claim to be
    at = {e: i for i, e in enumerate(T.HP_BAND_EDGES)}
    for k in (384, 385, 768, 769, 1536, 3072, 3073):
        assert c[at[f"band {k}"]] == k
    assert c[at["source in the warp before"]] == c[at["run at a warp's first column"]] == 700
    assert (o[at["open 384"]], o[at["open 385"]]) == (384, 385)
    assert o[at["open 384"]] == c[at["open 384"]]
    assert o[at["no open column"]] == 0 and o[at["16 one-column intervals"]] == 16
    assert d["win_lo"][at["past the state"]] + d["ivl"][at["past the state"], 0, 1] > \
        d["refs"].shape[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_band_plain_equals_jax_on_edge_rows(seed):
    """(b) Every row whose band fits equals the JAX scan over its whole
    window; a row past the limit gives (HIM, -1); no open column gives
    (HIM, 0), as the whole window does; the hp_col sources of the three
    source rows and the warp-border run lie where their names say."""
    d = T.hp_band_inputs(48, seed)
    got = dp_torch.last_row_hp_band_plain(*_args(d)).numpy()
    want = _jax_pairs(d)
    fits = entries.band_columns(d["ivl"])[1] <= BAND_ROW_COLS
    assert 0 < (~fits).sum() < len(fits)
    np.testing.assert_array_equal(got[:, fits], want[:, fits])
    assert (got[0, ~fits] == HIM).all() and (got[1, ~fits] == -1).all()
    at = {e: i for i, e in enumerate(T.HP_BAND_EDGES)}
    assert tuple(got[:, at["no open column"]]) == (HIM, 0)
    for edge, inside in (("source in another interval", True),
                         ("source in a closed gap", False)):
        r = at[edge]
        s, lo = int(d["strand"][r]), int(d["win_lo"][r])
        src = int(d["hpcs"][s, lo + d["ivl"][r, 1, 0]]) - 1 - lo
        assert src == 59 and (d["ivl"][r, 0, 1] > src) == inside
    # band column = window column there: a run from 380 (its cells in the
    # second warp take the source 379 in the first) and a run from 384
    for edge, start in (("source in the warp before", 380), ("run at a warp's first column",
                                                             384)):
        r = at[edge]
        s, lo = int(d["strand"][r]), int(d["win_lo"][r])
        assert int(d["hpcs"][s, lo + start]) == lo + start
        assert int(d["hpcs"][s, lo + start + 5]) == lo + start


@pytest.mark.parametrize("W,L,seed", [(2300, 48, 0), (400, 40, 3)])
def test_band_plain_equals_jax_on_wide_inputs(W, L, seed):
    """(b) testing.hp_wide_inputs' rows (read runs of 1, 2 and 31, a window
    inside a reference run, one-column bands, ties, rows past the state):
    those whose band fits, equal to the JAX scan."""
    d = T.hp_wide_inputs(W, L, seed)
    fits = entries.band_columns(d["ivl"])[1] <= BAND_ROW_COLS
    assert fits.sum() >= 3
    got = dp_torch.last_row_hp_band_plain(*_args(d)).numpy()
    np.testing.assert_array_equal(got[:, fits], _jax_pairs(d)[:, fits])


def test_wrapper_scores_both_forms_in_row_order():
    """(c) dp_last_row_hp with the band rows first, by warps: the band
    form's pairs and the full form's at the full rows' widest window (the
    rows wide_order gives the strand form, given to the full form here), in
    row order, each equal to the JAX scan; each form counted once, with its
    rows and the band rows on more than one warp."""
    d = T.hp_band_inputs(40, 3)
    order, classes, n_strand = entries.wide_order(entries.band_columns(d["ivl"])[1])
    n_band = sum(classes)
    assert all(classes) and n_band < len(order) and n_strand == len(order) - n_band
    d = {k: (v[order] if k in T.HP_WIDE_KEYS[6:] else v) for k, v in d.items()}
    want = _jax_pairs(d)
    width = int(d["ivl"][n_band:, :, 1].max())
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row_hp(*_args(d), width, n_band, classes).numpy()
    np.testing.assert_array_equal(got, want)
    assert (dp_cuda.last_row_hp_band_plain_calls, dp_cuda.last_row_hp_plain_calls) == (1, 1)
    assert dp_cuda.last_row_hp_band_launches == dp_cuda.last_row_hp_launches == 0
    assert (dp_cuda.last_row_hp_band_rows, dp_cuda.last_row_hp_rows) == (n_band,
                                                                         len(order) - n_band)
    assert dp_cuda.last_row_hp_band_multi_rows == n_band - classes[0]
    # all rows to one form: the other is not called
    args = _args(d)
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row_hp(*args[:6], *(a[:n_band] for a in args[6:]), 0,
                                 n_band, classes).numpy()
    np.testing.assert_array_equal(got, want[:, :n_band])
    assert (dp_cuda.last_row_hp_band_plain_calls, dp_cuda.last_row_hp_plain_calls) == (1, 0)


def test_wrapper_checks_the_split():
    d = T.hp_band_inputs(40, 4, copies=1)
    args = _args(d)
    R = len(d["lengths"])
    for n_band in (-1, R + 1):
        with pytest.raises(ValueError, match="n_band"):
            dp_cuda.dp_last_row_hp(*args, 100, n_band)
    # the width bounds the full rows only
    with pytest.raises(ValueError, match="width"):
        dp_cuda.dp_last_row_hp(*args, 0, R - 1)
    dp_cuda.dp_last_row_hp(*args, 0, R)
    # the band classes count the band rows
    for classes in ((R - 1, 0, 0, 0), (R, 1, 0, 0), (R + 1, -1)):
        with pytest.raises(ValueError, match="band_classes"):
            dp_cuda.dp_last_row_hp(*args, 0, R, classes)
    # a band form's mark of a row too wide for it is refused by the merge
    rows = entries.WideRows(np.array([0]), np.array([0]), np.array([0], np.int8),
                            np.array([5], np.int32), d["ivl"][:1], d["s2chr"][:1],
                            d["lengths"][:1], 500, 1, 0)
    fb, fa, rb, ra = (np.zeros(1, np.int64) for _ in range(4))
    with pytest.raises(RuntimeError, match="band too wide"):
        entries.merge_wide(fb, fa, rb, ra, rows, np.array([HIM]), np.array([-1]))


@pytest.mark.parametrize("seed,kmer,circular", CASES, ids=IDS)
def test_pass1_hp_batch_split(seed, kmer, circular):
    """(d) A pass-1 -h batch's wide rows: the rows whose band columns fit
    come first, by the warps each takes, each class in its order, as
    n_band; the rest keep their order as the strand form's n_strand, and
    no row is left to the full form (full_width 0); the same (read,
    strand) rows as without -h; the band rows through the wrapper equal the
    JAX scan on their windows."""
    _, scorer, sm, _, _, lens, prep = _setup(seed, kmer, circular)
    s2chr, fw_ws, rc_ws, fw_ivg, rc_ivg, flags = prep
    rows = entries.wide_rows(flags, lens, s2chr, fw_ivg, rc_ivg, hp=True)
    plain = entries.wide_rows(flags, lens, s2chr, fw_ivg, rc_ivg)
    # the rows as they were before any split: by strand, then read
    unsplit = np.lexsort((plain.read, plain.strand))
    for k in ("read", "strand", "win_lo", "ivl"):
        setattr(plain, k, getattr(plain, k)[unsplit])
    g = entries.band_warps(entries.band_columns(plain.ivl)[1])
    order = np.r_[tuple(np.flatnonzero(g == w) for w in (*entries.BAND_WARPS, 0))]
    assert rows.n_band == (g > 0).sum() and rows.n_strand == (g == 0).sum()
    assert rows.band_classes == tuple(int((g == w).sum()) for w in entries.BAND_WARPS)
    for k in ("read", "strand", "win_lo", "ivl"):
        np.testing.assert_array_equal(getattr(rows, k), getattr(plain, k)[order])
    win = rows.ivl[:, :, 1].max(1)
    assert rows.full_width == 0 and rows.width == win.max()
    assert rows.n_band > 0 or kmer < 0
    if not rows.n_band:
        return
    st = scorer.state
    d = dict(refs=st.refs.numpy(), refchr=st.refchr.numpy(), hpcs=st.hpcs.numpy(),
             submat=sm, pengop=st.pengop.numpy(), b2i=st.b2i.numpy(),
             strand=rows.strand[: rows.n_band], win_lo=rows.win_lo[: rows.n_band],
             ivl=rows.ivl[: rows.n_band], s2chr=rows.s2c[: rows.n_band],
             lengths=rows.lengths[: rows.n_band], width=int(win[: rows.n_band].max()))
    got = dp_cuda.dp_last_row_hp(*_args(d), 0, rows.n_band, rows.band_classes).numpy()
    np.testing.assert_array_equal(got, _jax_pairs(d))
