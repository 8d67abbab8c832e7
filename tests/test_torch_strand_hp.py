"""The ``-h`` strand form of the general-width scorer
(``dp_cuda.dp_last_row_hp``'s rows after the band form's; its plain version
``dp_torch.last_row_hp_strand_plain`` on the CPU), which scores an ``-h``
row whose band spans up to a whole strand, against ``mia_tpu``'s
``dp_jax.batch_last_row_hp`` and ``dp_jax.batch_best_and_aec`` over the
row's window.

(a) The plain ``-h`` strand form on ``testing.hp_strand_inputs``' rows
(whole strands of a 4,000-column circular strand in one and in 16
intervals, reference runs across the border of two 1,152-column slices and
at a slice's first column, an hp_col source that is not open, a reference
run longer than a slice with reads of runs of 4, 31, 32 and 33 bases there,
a read across the origin, a tie in the wrap, a window past the state, a
read of 1 base, no open column), exact, and the edges are what they claim.
(b) ``dp_last_row_hp``'s three forms in one call on
``testing.mixed_hp_wide_inputs`` (band rows of every warp class, strand
rows, full rows), in row order, with their counters and its input checks.
(c) An ``-h`` pass-1 batch without ``-k`` on a 4,000-column circular
reference: every row a whole strand, all of them the strand form's, equal
to the JAX scan.

Tolerance: exact equality of every (best, column).
"""
import numpy as np
import pytest
import torch

from mia_tpu.ops.pssm import init_flatsubmat
from mia_tpu_torch import testing as T
from mia_tpu_torch.core import entries
from mia_tpu_torch.core import torch_engine as te
from mia_tpu_torch.core.entries import BAND_ROW_COLS, HIM, HPW_ROUTE, L_MAX, MAX_INTERVALS, WIN_W
from mia_tpu_torch.core.hostbatch import FLAG_HOST_ONLY, BatchHost
from mia_tpu_torch.ops import dp_cuda, dp_torch
from mia_tpu_torch.utils.encoding import encode_seq, revcom

from .test_torch_band_hp import _args, _jax_pairs
from .test_torch_wide_pass1_hp import WRAP, _dense, _reads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread a worker, so that several workers on one machine do
    not spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_strand_hp_plain_equals_jax(seed):
    """(a) Every row equals the JAX scan over its whole window; no open
    column gives (HIM, 0); the tied row holds its maximum at two or more
    columns and answers the first."""
    d = T.hp_strand_inputs(48, seed)
    got = dp_torch.last_row_hp_strand_plain(*_args(d)).numpy()
    np.testing.assert_array_equal(got, _jax_pairs(d))
    at = {e: i for i, e in enumerate(T.HP_STRAND_EDGES)}
    assert tuple(got[:, at["no open column"]]) == (HIM, 0)
    from mia_tpu.ops import dp_jax

    last = np.asarray(dp_jax.batch_last_row_hp(**_dense(d)))
    r = at["tie in the wrap"]
    best = np.flatnonzero(last[r] == last[r].max())
    assert len(best) >= 2 and got[1, r] == best[0]


@pytest.mark.parametrize("seed", [0, 3])
def test_strand_hp_edges_are_what_they_claim(seed):
    """(a) Every row but the empty one takes the strand form (band past
    3,072 columns); the border rows' reference runs lie where their names
    say (band column = window column there); the long run spans the first
    three slices; the read runs around HPW_ROUTE are there."""
    d = T.hp_strand_inputs(48, seed)
    S = T.STRAND_SLICE
    assert S == 1152
    n = len(T.HP_STRAND_EDGES)
    cols = entries.band_columns(d["ivl"])[1]
    for r, c in enumerate(cols):
        edge = T.HP_STRAND_EDGES[r % n]
        assert (c == 0) if edge == "no open column" else (BAND_ROW_COLS < c
                                                           <= entries.STRAND_COLS), edge
        s, lo = int(d["strand"][r]), int(d["win_lo"][r])
        h = d["hpcs"][s, lo:] - lo  # window-local run starts
        if edge == "run across a slice border":
            assert any(h[x - 3] == x - 3 and h[x + 2] == x - 3 for x in (S, 2 * S))
        elif edge == "run at a slice's first column":
            assert any(h[x] == x and h[x + 5] == x for x in (S, 2 * S))
        elif edge == "source not open":
            iv = d["ivl"][r]
            x = int(iv[1, 0])
            assert iv[0, 1] == x - 1 and h[x] == x and h[x + 5] == x and (x + 2) % S == 0
        elif edge == "run longer than a slice":
            assert (h[1000:2400] == 1000).all() and h[999] != 1000
    runs = {int(k) for r in range(n) if T.HP_STRAND_EDGES[r].startswith("read run of ")
            for k in np.diff(np.flatnonzero(np.diff(np.r_[-1, d["s2chr"][r].astype(int), -1])))}
    assert {HPW_ROUTE - 1, HPW_ROUTE, HPW_ROUTE + 1} <= runs


def test_wrapper_scores_three_forms_in_row_order():
    """(b) dp_last_row_hp on band rows of all four warp classes, strand rows
    and full rows in one call, in row order, each equal to the JAX scan;
    the band and strand rows as entries.wide_order orders them; each form
    counted once, with its rows; the strand rows alone call only the strand
    form."""
    d = T.mixed_hp_wide_inputs(48, 0)
    n_band, classes, n_strand = d["n_band"], d["band_classes"], d["n_strand"]
    R = len(d["lengths"])
    n_full = R - n_band - n_strand
    assert all(classes) and n_strand >= 10 and n_full == 3
    order, w_classes, w_strand = entries.wide_order(
        entries.band_columns(d["ivl"][: n_band + n_strand])[1])
    np.testing.assert_array_equal(order, np.arange(n_band + n_strand))
    assert (w_classes, w_strand) == (tuple(classes), n_strand)
    want = _jax_pairs(d)
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row_hp(*_args(d), d["width"], n_band, classes, n_strand).numpy()
    np.testing.assert_array_equal(got, want)
    assert (dp_cuda.last_row_hp_band_plain_calls, dp_cuda.last_row_hp_strand_plain_calls,
            dp_cuda.last_row_hp_plain_calls) == (1, 1, 1)
    assert (dp_cuda.last_row_hp_band_rows, dp_cuda.last_row_hp_strand_rows,
            dp_cuda.last_row_hp_rows) == (n_band, n_strand, n_full)
    assert (dp_cuda.last_row_hp_band_launches, dp_cuda.last_row_hp_strand_launches,
            dp_cuda.last_row_hp_launches) == (0, 0, 0)
    args = _args(d)
    part = slice(n_band, n_band + n_strand)
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row_hp(*args[:6], *(a[part] for a in args[6:]), 0, 0, (), n_strand)
    np.testing.assert_array_equal(got.numpy(), want[:, part])
    assert (dp_cuda.last_row_hp_band_plain_calls, dp_cuda.last_row_hp_strand_plain_calls,
            dp_cuda.last_row_hp_plain_calls) == (0, 1, 0)


def test_wrapper_checks_the_strand_split():
    d = T.hp_strand_inputs(40, 4, copies=1)
    args = _args(d)
    R = len(d["lengths"])
    for n_band, n_strand in ((0, -1), (0, R + 1), (1, R)):
        with pytest.raises(ValueError, match="n_strand"):
            dp_cuda.dp_last_row_hp(*args, 100, n_band, (), n_strand)
    # no full row: the width is not needed
    dp_cuda.dp_last_row_hp(*args, 0, 0, (), R)
    with pytest.raises(ValueError, match="width"):
        dp_cuda.dp_last_row_hp(*args, 0, 0, (), R - 1)


def test_pass1_hp_whole_strands_take_the_strand_form():
    """(c) An -h pass-1 batch without -k on a 4,000-column circular
    reference: every WIDE read's rows span a whole strand (band 4,256
    columns, past the band form's 3,072), all of them the strand form's, no
    row the full form's; through the scorer they equal the JAX scan on
    their windows."""
    rng = np.random.default_rng(6)
    ref = T._runs_string(rng, 4000)
    fw, rc = ref + ref[:WRAP], revcom(ref) + revcom(ref)[:WRAP]
    len1 = len(fw)
    sm = (init_flatsubmat() + rng.integers(-60, 60, (31, 5, 5))).astype(np.int32)
    bhost = BatchHost.create(fw, rc, len1, sm, None, -1, False, WIN_W, MAX_INTERVALS, hp=True)
    assert bhost is not None
    scorer = te.Pass1Scorer(encode_seq(fw), encode_seq(rc), len1, sm, batch=256,
                            device="cpu", hp_seqs=(fw, rc))
    reads = _reads(rng, ref)[:24]
    arena, off, lens = bhost.pack_reads(reads)
    s2c, fw_ws, rc_ws, fw_ivg, rc_ivg, flags = bhost.prepare(arena, off, lens, L_MAX,
                                                              MAX_INTERVALS)[:6]
    bhost.close()
    flags[entries.longest_runs(arena, off, lens) >= HPW_ROUTE] |= FLAG_HOST_ONLY
    s2chr = entries.pack_chars(arena, off[:-1], lens)
    rows = entries.wide_rows(flags, lens, s2chr, fw_ivg, rc_ivg, hp=True)
    assert rows.n_band == 0 and rows.n_strand == rows.n > 0 and rows.full_width == 0
    assert (entries.band_columns(rows.ivl)[1] > BAND_ROW_COLS).all()
    dp_cuda.reset_counts()
    got = te.score_wide(scorer.state, rows.full_width, rows.n_band, rows.band_classes,
                        rows.n_strand, *(torch.from_numpy(np.ascontiguousarray(a)) for a in (
                            rows.strand, rows.win_lo, rows.ivl, rows.s2c, rows.lengths)))
    assert (dp_cuda.last_row_hp_strand_plain_calls, dp_cuda.last_row_hp_plain_calls,
            dp_cuda.last_row_hp_band_plain_calls) == (1, 0, 0)
    assert dp_cuda.last_row_hp_strand_rows == rows.n > 0 and dp_cuda.last_row_hp_rows == 0
    st = scorer.state
    d = dict(refs=st.refs.numpy(), refchr=st.refchr.numpy(), hpcs=st.hpcs.numpy(), submat=sm,
             pengop=st.pengop.numpy(), b2i=st.b2i.numpy(), strand=rows.strand,
             win_lo=rows.win_lo, ivl=rows.ivl, s2chr=rows.s2c, lengths=rows.lengths,
             width=rows.width)
    np.testing.assert_array_equal(got.numpy(), _jax_pairs(d))
