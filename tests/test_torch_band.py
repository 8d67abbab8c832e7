"""The band form of the general-width scorer without ``-h``
(``dp_cuda.dp_last_row_strand``'s first ``n_band`` rows; its plain version
``dp_torch.last_row_band_plain`` on the CPU), which scores a wide row on its
band columns only, against ``mia_tpu``'s ``dp_jax.batch_last_row`` and
``dp_jax.batch_best_and_aec`` over the row's whole window.

(a) The band columns (``entries.band_columns``, ``dp_torch.band_layout``)
against a count over the dense band, and the warps a row takes
(``entries.band_warps``).  (b) The plain band form on
``testing.band_inputs``' edge rows (band columns of 384, 385, 768, 769,
1,536, 3,072 and 3,073, open columns of 384 and 385, bands at window
columns 0 and 1, touching, overlapping and empty intervals, 16 one-column
intervals, gaps of one and two columns, no open column, a band past the
strand state, reads of 1 and 2 bases, a band over both ends of a circular
strand, narrow and over 384 columns).  (c) The wrapper's band and full
forms in one call, the band rows ordered by warps, in row order, with
their counters, and its input checks and ``merge_wide``'s refusal.  (d)
The split of the three pass-1 batches of ``test_torch_wide_pass1``
(``entries.wide_rows``: band classes, strand and full rows) and their band
rows through the wrapper.

Tolerance: exact equality of every (best, column).
"""
import numpy as np
import pytest
import torch

from mia_tpu.ops import dp_jax
from mia_tpu_torch import testing as T
from mia_tpu_torch.core import entries
from mia_tpu_torch.core.entries import BAND_COLS, BAND_ROW_COLS, HIM, STRAND_COLS
from mia_tpu_torch.ops import dp_cuda, dp_torch

from .test_torch_wide_pass1 import CASES, IDS, _setup


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread a worker, so that several workers on one machine do
    not spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_pairs(d: dict) -> np.ndarray:
    """[2, R] (best, first column of the best) of dp_jax.batch_last_row
    over each row's window of ``d["width"]`` columns, made in numpy as
    ``entries.wide_inputs`` makes it (past the state: code 4)."""
    W = d["width"]
    WTOT = d["refs"].shape[1]
    g = d["win_lo"].astype(np.int64)[:, None] + np.arange(W)[None, :]
    s1c = np.where(g < WTOT, d["refs"][d["strand"].astype(np.int64)[:, None],
                                       np.minimum(g, WTOT - 1)], 4).astype(np.int32)
    iv = d["ivl"].astype(np.int64)
    cols = np.arange(W)[None, None, :]
    mask = ((cols >= iv[:, :, 0:1]) & (cols < iv[:, :, 1:2])).any(1)
    depths = T.depths_numpy(d["lengths"], d["s2c"].shape[1])
    last = np.asarray(dp_jax.batch_last_row(s1c, mask, d["s2c"], d["lengths"], depths,
                                            d["submat"]))
    return np.stack([np.asarray(x) for x in dp_jax.batch_best_and_aec(last)])


def _ivl_hi(d: dict, r: int) -> int:
    return int(d["ivl"][r, :, 1].max())


def _args(d: dict) -> list:
    return [torch.from_numpy(np.ascontiguousarray(d[k])) for k in T.BAND_KEYS]


@pytest.mark.parametrize("seed", [0, 1])
def test_band_layout_at_the_plain_limit(seed):
    """(a) band_layout: the union of the intervals with the two columns
    before each run, in order, for every row up to 3,072 band columns; none
    for a row past it.  The edges are what they claim, and each band row
    takes the fewest warps of 384 columns that hold it."""
    d = T.band_inputs(40, seed)
    ivl = d["ivl"]
    W = int(ivl[:, :, 1].max()) + 2
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
    at = {e: i for i, e in enumerate(T.BAND_EDGES)}
    for k in (BAND_COLS, BAND_COLS + 1):
        assert c[at[f"band {k}"]] == k and o[at[f"open {k}"]] == c[at[f"open {k}"]] == k
    warps = entries.band_warps(c)
    for k, g in ((384, 1), (385, 2), (768, 2), (769, 4), (1536, 4), (3072, 8), (3073, 0)):
        assert c[at[f"band {k}"]] == k and warps[at[f"band {k}"]] == g, k
    assert ((warps == 0) == (c > BAND_ROW_COLS)).all()
    assert ((BAND_COLS * warps >= c) | (warps == 0)).all()
    assert ((BAND_COLS * warps // 2 < c) | (warps <= 1)).all()
    assert o[at["no open column"]] == 0 and o[at["16 one-column intervals"]] == 16
    assert d["win_lo"][at["past the state"]] + ivl[at["past the state"], 0, 1] > \
        d["refs"].shape[1]
    for edge, fits in (("wrapping both ends", True), ("wrapping both ends, wide", False)):
        r = at[edge]
        assert ivl[r, :, 1].max() > 3000 and ivl[r, :, 0].min() == 0
        assert (c[r] <= BAND_COLS) == fits


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_band_plain_equals_jax_on_edge_rows(seed):
    """(b) Every row whose band fits equals the JAX scan over its whole
    window; a row past the limit gives (HIM, -1); no open column gives
    (HIM, 0), as the whole window does."""
    d = T.band_inputs(48, seed)
    got = dp_torch.last_row_band_plain(*_args(d)).numpy()
    want = _jax_pairs(d)
    fits = entries.band_columns(d["ivl"])[1] <= BAND_ROW_COLS
    assert 0 < (~fits).sum() < len(fits)
    np.testing.assert_array_equal(got[:, fits], want[:, fits])
    assert (got[0, ~fits] == HIM).all() and (got[1, ~fits] == -1).all()
    at = {e: i for i, e in enumerate(T.BAND_EDGES)}
    assert tuple(got[:, at["no open column"]]) == (HIM, 0)
    # the wrapping read aligns across the origin: its best column lies in
    # the wrap, past the strand's 3,000 columns
    r = at["wrapping both ends"]
    assert got[0, r] > 0 and 3000 <= got[1, r] < _ivl_hi(d, r)


def test_wrapper_scores_both_forms_in_row_order():
    """(c) dp_last_row_strand with the band rows first, by warps: the band
    form's pairs and the full form's at the full rows' widest window (the
    rows wide_order gives the strand form, given to the full form here), in
    row order, each equal to the JAX scan; each form counted once, with its
    rows and the band rows on more than one warp."""
    d = T.band_inputs(40, 3)
    order, classes, n_strand = entries.wide_order(entries.band_columns(d["ivl"])[1])
    n_band = sum(classes)
    assert all(classes) and n_band < len(order) and n_strand == len(order) - n_band
    d = {k: (v[order] if k in T.BAND_KEYS[2:] else v) for k, v in d.items()}
    want = _jax_pairs(d)
    width = int(d["ivl"][n_band:, :, 1].max())
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row_strand(*_args(d), width, n_band, classes).numpy()
    np.testing.assert_array_equal(got, want)
    assert (dp_cuda.last_row_band_plain_calls, dp_cuda.last_row_plain_calls) == (1, 1)
    assert dp_cuda.last_row_band_launches == dp_cuda.last_row_launches == 0
    assert (dp_cuda.last_row_band_rows, dp_cuda.last_row_rows) == (n_band, len(order) - n_band)
    assert dp_cuda.last_row_band_multi_rows == n_band - classes[0]
    # all rows to one form: the other is not called
    args = _args(d)
    for sl, w, nb, cl, calls in ((slice(None, n_band), 0, n_band, classes, (1, 0)),
                                 (slice(n_band, None), width, 0, (), (0, 1))):
        dp_cuda.reset_counts()
        got = dp_cuda.dp_last_row_strand(*args[:2], *(a[sl] for a in args[2:]), w, nb, cl)
        np.testing.assert_array_equal(got.numpy(), want[:, sl])
        assert (dp_cuda.last_row_band_plain_calls, dp_cuda.last_row_plain_calls) == calls


def test_wrapper_checks_the_split():
    d = T.band_inputs(40, 4, copies=1)
    args = _args(d)
    R = len(d["lengths"])
    for n_band in (-1, R + 1):
        with pytest.raises(ValueError, match="n_band"):
            dp_cuda.dp_last_row_strand(*args, 100, n_band)
    # the width bounds the full rows only
    with pytest.raises(ValueError, match="width"):
        dp_cuda.dp_last_row_strand(*args, 0, R - 1)
    dp_cuda.dp_last_row_strand(*args, 0, R)
    # the band classes count the band rows
    for classes in ((R - 1, 0, 0, 0), (R, 1, 0, 0), (R - 1, 0, 0, 0, 1), (R + 1, -1)):
        with pytest.raises(ValueError, match="band_classes"):
            dp_cuda.dp_last_row_strand(*args, 0, R, classes)
    dp_cuda.dp_last_row_strand(*args, 0, R, (R - 3, 1, 1, 1))
    with pytest.raises(ValueError, match="n_strand"):
        dp_cuda.dp_last_row_strand(*args, 0, R, (), 1)
    with pytest.raises(TypeError, match="s2c"):
        dp_cuda.dp_last_row_strand(*args[:5], args[5].to(torch.int8), args[6], 0, R)
    # a band form's mark of a row too wide for it is refused by the merge
    rows = entries.WideRows(np.array([0]), np.array([0]), np.array([0], np.int8),
                            np.array([5], np.int32), d["ivl"][:1], d["s2c"][:1],
                            d["lengths"][:1], 600, 1, 0)
    fb, fa, rb, ra = (np.zeros(1, np.int64) for _ in range(4))
    with pytest.raises(RuntimeError, match="band too wide for the band form"):
        entries.merge_wide(fb, fa, rb, ra, rows, np.array([HIM]), np.array([-1]))


@pytest.mark.parametrize("seed,kmer,circular", CASES, ids=IDS)
def test_pass1_batch_split(seed, kmer, circular):
    """(d) A pass-1 batch's wide rows without -h: the rows whose band
    columns fit the band form come first, by the warps each takes
    (band_classes), then the strand form's rows (band up to STRAND_COLS),
    then the rest; each part keeps its (strand, read) order, and
    full_width is the full rows' widest window.  Without -k every row spans
    a whole strand and takes the strand form.  The band rows through the
    wrapper equal the JAX scan on their windows."""
    _, scorer, sm, _, _, lens, prep = _setup(seed, kmer, circular)
    s2c, fw_ws, rc_ws, fw_ivg, rc_ivg, flags = prep
    rows = entries.wide_rows(flags, lens, s2c, fw_ivg, rc_ivg)
    cols = entries.band_columns(rows.ivl)[1]
    g = entries.band_warps(cols)
    nb, ns = rows.n_band, rows.n_strand
    assert rows.band_classes == tuple(int((g == w).sum()) for w in entries.BAND_WARPS)
    assert nb == sum(rows.band_classes) and (g[:nb] > 0).all()
    assert (np.diff(g[:nb]) >= 0).all()
    assert ((cols[nb:nb + ns] > BAND_ROW_COLS) & (cols[nb:nb + ns] <= STRAND_COLS)).all()
    assert (cols[nb + ns:] > STRAND_COLS).all()
    parts = [slice(nb + ns, None), slice(nb, nb + ns)]
    at = 0
    for c in rows.band_classes:
        parts.append(slice(at, at + c))
        at += c
    for part in parts:
        key = rows.strand[part].astype(np.int64) * len(lens) + rows.read[part]
        assert (np.diff(key) > 0).all()
    win = rows.ivl[:, :, 1].max(1)
    assert rows.full_width == win[nb + ns:].max(initial=0) and rows.width == win.max()
    if kmer < 0:
        # whole strands of 2,256 columns: eight warps of the band form
        assert rows.band_classes == (0, 0, 0, rows.n) and rows.n > 0
        return
    assert 0 < nb
    d = dict(refs=scorer.state.refs.numpy(), submat=sm, strand=rows.strand[:nb],
             win_lo=rows.win_lo[:nb], ivl=rows.ivl[:nb], s2c=rows.s2c[:nb],
             lengths=rows.lengths[:nb], width=int(win[:nb].max()))
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row_strand(*_args(d), 0, nb, rows.band_classes).numpy()
    np.testing.assert_array_equal(got, _jax_pairs(d))
    assert (dp_cuda.last_row_band_plain_calls, dp_cuda.last_row_plain_calls) == (1, 0)
