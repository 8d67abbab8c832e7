"""The strand form of the general-width scorer without ``-h``
(``dp_cuda.dp_last_row_strand``'s rows after the band form's; its plain
version ``dp_torch.last_row_strand_plain`` on the CPU), which scores a row
whose band spans up to a whole strand, against ``mia_tpu``'s
``dp_jax.batch_last_row`` and ``dp_jax.batch_best_and_aec`` over the row's
window.

(a) The plain strand form on ``testing.strand_inputs``' rows (whole
strands of a 2,000-column circular strand in one and in 16 intervals, a
read across the origin, ties in the wrap and in a repeat, no open column, a
read of 1 base, a window past the state), exact, and the earliest of tied
columns.  (b) The wrapper's three forms in one call on
``testing.mixed_wide_inputs`` (band rows of every warp class, strand rows,
full rows past 18,432 band columns), in row order, with their counters.
(c) A pass-1 batch on a 4,000-column circular reference without ``-k``:
every row a whole strand, all of them the strand form's, equal to the JAX
scan.

Tolerance: exact equality of every (best, column).
"""
import numpy as np
import pytest
import torch

from mia_tpu.ops import dp_jax
from mia_tpu_torch import testing as T
from mia_tpu_torch.core import entries
from mia_tpu_torch.core import torch_engine as te
from mia_tpu_torch.core.entries import BAND_ROW_COLS, HIM, L_MAX, MAX_INTERVALS, WIN_W
from mia_tpu_torch.core.hostbatch import BatchHost
from mia_tpu_torch.ops import dp_cuda, dp_torch
from mia_tpu_torch.ops.pssm import init_flatsubmat
from mia_tpu_torch.utils.encoding import encode_seq, revcom

from .test_torch_band import _args, _jax_pairs
from .test_torch_wide_pass1 import _reads, _reference


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread a worker, so that several workers on one machine do
    not spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_last(d: dict) -> np.ndarray:
    """[R, W] the JAX scan's last row over each row's window, as
    ``_jax_pairs`` makes it."""
    W = d["width"]
    WTOT = d["refs"].shape[1]
    g = d["win_lo"].astype(np.int64)[:, None] + np.arange(W)[None, :]
    s1c = np.where(g < WTOT, d["refs"][d["strand"].astype(np.int64)[:, None],
                                       np.minimum(g, WTOT - 1)], 4).astype(np.int32)
    iv = d["ivl"].astype(np.int64)
    cols = np.arange(W)[None, None, :]
    mask = ((cols >= iv[:, :, 0:1]) & (cols < iv[:, :, 1:2])).any(1)
    return np.asarray(dp_jax.batch_last_row(s1c, mask, d["s2c"], d["lengths"],
                                            T.depths_numpy(d["lengths"], d["s2c"].shape[1]),
                                            d["submat"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_strand_plain_equals_jax(seed):
    """(a) Every row equals the JAX scan over its whole window; no open
    column gives (HIM, 0); the tied rows hold their maximum at two or more
    columns and answer the first."""
    d = T.strand_inputs(48, seed)
    got = dp_torch.last_row_strand_plain(*_args(d)).numpy()
    np.testing.assert_array_equal(got, _jax_pairs(d))
    at = {e: i for i, e in enumerate(T.STRAND_EDGES)}
    assert tuple(got[:, at["no open column"]]) == (HIM, 0)
    assert (entries.band_columns(d["ivl"])[1][at["whole strand"]]) == 2400
    last = _jax_last(d)
    for edge in ("tie in the wrap", "tie in a repeat"):
        r = at[edge]
        best = np.flatnonzero(last[r] == last[r].max())
        assert len(best) >= 2 and got[1, r] == best[0], edge


def test_wrapper_scores_three_forms_in_row_order():
    """(b) dp_last_row_strand on rows of every form, ordered as
    entries.wide_rows orders them: the band form's pairs (all four warp
    classes), the strand form's and the full form's at the full rows'
    widest window, in row order, each equal to the JAX scan; each form
    counted once, with its rows."""
    d = T.mixed_wide_inputs(48, 0)
    order, classes, n_strand = entries.wide_order(entries.band_columns(d["ivl"])[1])
    n_band = sum(classes)
    n_full = len(order) - n_band - n_strand
    assert all(classes) and n_strand >= 4 and n_full >= 4
    d = {k: (v[order] if k in T.BAND_KEYS[2:] else v) for k, v in d.items()}
    width = int(d["ivl"][n_band + n_strand:, :, 1].max())
    assert width > entries.STRAND_COLS
    want = _jax_pairs(d)
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row_strand(*_args(d), width, n_band, classes, n_strand).numpy()
    np.testing.assert_array_equal(got, want)
    assert (dp_cuda.last_row_band_plain_calls, dp_cuda.last_row_strand_plain_calls,
            dp_cuda.last_row_plain_calls) == (1, 1, 1)
    assert (dp_cuda.last_row_band_rows, dp_cuda.last_row_strand_rows,
            dp_cuda.last_row_rows) == (n_band, n_strand, n_full)
    assert dp_cuda.last_row_band_multi_rows == n_band - classes[0]
    assert dp_cuda.last_row_band_launches == dp_cuda.last_row_strand_launches == 0
    # the strand rows alone: only the strand form is called
    args = _args(d)
    part = slice(n_band, n_band + n_strand)
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row_strand(*args[:2], *(a[part] for a in args[2:]), 0, 0, (),
                                     n_strand)
    np.testing.assert_array_equal(got.numpy(), want[:, part])
    assert (dp_cuda.last_row_band_plain_calls, dp_cuda.last_row_strand_plain_calls,
            dp_cuda.last_row_plain_calls) == (0, 1, 0)


def test_pass1_whole_strands_take_the_strand_form():
    """(c) A pass-1 batch without -k on a 4,000-column circular reference:
    every WIDE read's rows span a whole strand (band 4,256 columns, past the
    band form's 3,072), all of them the strand form's; through the scorer
    they equal the JAX scan on their windows."""
    rng = np.random.default_rng(4)
    ref = _reference(rng, 4000)
    fw, rc = ref + ref[:256], revcom(ref) + revcom(ref)[:256]
    len1 = len(fw)
    sm = (init_flatsubmat() + rng.integers(-60, 60, (31, 5, 5))).astype(np.int32)
    bhost = BatchHost.create(fw, rc, len1, sm, None, -1, False, WIN_W, MAX_INTERVALS)
    assert bhost is not None
    scorer = te.Pass1Scorer(encode_seq(fw), encode_seq(rc), len1, sm, batch=256, device="cpu")
    reads = _reads(rng, ref)[:24]
    arena, off, lens = bhost.pack_reads(reads)
    s2c, fw_ws, rc_ws, fw_ivg, rc_ivg, flags = bhost.prepare(arena, off, lens, L_MAX,
                                                             MAX_INTERVALS)[:6]
    bhost.close()
    rows = entries.wide_rows(flags, lens, s2c, fw_ivg, rc_ivg)
    assert rows.n_band == 0 and rows.n_strand == rows.n > 0
    assert (entries.band_columns(rows.ivl)[1] > BAND_ROW_COLS).all()
    dp_cuda.reset_counts()
    got = te.score_wide(scorer.state, rows.full_width, rows.n_band, rows.band_classes,
                        rows.n_strand, *(torch.from_numpy(np.ascontiguousarray(a)) for a in (
                            rows.strand, rows.win_lo, rows.ivl, rows.s2c, rows.lengths)))
    assert (dp_cuda.last_row_strand_plain_calls, dp_cuda.last_row_plain_calls) == (1, 0)
    d = dict(refs=scorer.state.refs.numpy(), submat=sm, strand=rows.strand,
             win_lo=rows.win_lo, ivl=rows.ivl, s2c=rows.s2c, lengths=rows.lengths,
             width=rows.width)
    np.testing.assert_array_equal(got.numpy(), _jax_pairs(d))
